"""The port's analysis (tpat_tpu_torch.analysis: stats, extract_stats,
reducers; ops.pruning.compose_topk_indices) against the JAX package's, on
the CPU: mirrors of tests/test_analysis.py on the port's modules, the
port's numpy KMeans against scikit-learn's, the numeric subcommands with
scikit-learn and matplotlib unimportable, and the two packages'
extract_stats giving the same Kendall JSON."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpat_tpu.analysis import extract_stats as jextract
from tpat_tpu.analysis import stats as JS
from tpat_tpu.ops import pruning as jpruning
from tpat_tpu.utils.features import FeatureWriter as JaxFeatureWriter
from tpat_tpu_torch.analysis import extract_stats, reducers
from tpat_tpu_torch.analysis import stats as S
from tpat_tpu_torch.ops import pruning
from tpat_tpu_torch.utils.features import FeatureWriter, combine_feature_dict


def brute_force_tau(score, rank):
    b, n = score.shape
    c = d = 0
    for i in range(b):
        for p in range(n):
            for q in range(p + 1, n):
                prod = (score[i, q] - score[i, p]) * (rank[i, q] - rank[i, p])
                if prod >= 0:
                    c += 1
                else:
                    d += 1
    return (c - d) / ((n * (n - 1) // 2) * b)


def test_kendall_tau_matches_bruteforce(rng):
    score = rng.normal(size=(3, 12)).astype(np.float32)
    rank = rng.integers(0, 5, size=(3, 12)).astype(np.float32)
    got = S.kendall_tau_pairs(score, rank)
    assert abs(got - brute_force_tau(score, rank)) < 1e-12
    assert got == JS.kendall_tau_pairs(score, rank)


def test_kendall_perfect_and_inverse():
    score = np.arange(10, dtype=np.float32)[None]
    rank = np.arange(10, dtype=np.float32)[None]
    assert S.kendall_tau_pairs(score, rank) == 1.0
    assert S.kendall_tau_pairs(score, -rank) == -1.0


def test_kmeans_rank_ascending(rng):
    stat = np.concatenate([rng.normal(-5, 0.1, size=(2, 20)),
                           rng.normal(0, 0.1, size=(2, 20)),
                           rng.normal(5, 0.1, size=(2, 20))],
                          axis=1).astype(np.float32)
    rank, info = S.kmeans_rank(stat, n_clusters=3)
    assert rank[stat < -3].max() == 0
    assert set(np.unique(rank[(stat > -1) & (stat < 1)])) == {1.0}
    assert rank[stat > 3].min() == 2
    mins = [i[0] for i in info]
    assert mins == sorted(mins)


def _mels(seed, b, t, f):
    """Seeded mel-like batches: a per-clip frequency profile, a time
    envelope and noise, so the patch statistics spread over several
    intensity levels."""
    g = np.random.default_rng(seed)
    profile = g.normal(size=(b, 1, 1, f)) * 2.0
    envelope = np.cumsum(g.normal(size=(b, 1, t, 1)) * 0.3, axis=2)
    return (profile + envelope + g.normal(size=(b, 1, t, f))).astype(np.float32)


@pytest.mark.parametrize("seed,shape", [
    (0, (4, 64, 32)), (1, (16, 128, 128)), (2, (3, 512, 128)),
    (3, (64, 128, 64)), (4, (1, 48, 48)),
])
def test_kmeans_rank_equals_scikit_learn(seed, shape):
    """The port's kmeans_rank gives the same rank array as
    tpat_tpu.analysis.stats.kmeans_rank (scikit-learn's KMeans(5,
    random_state=123)), with the same cluster bounds (within 1e-6) and
    shares, on the patch means and patch stds of seeded mel batches."""
    mel = _mels(seed, *shape)
    for kind in ("mean", "std"):
        stat = S.patch_stats_np(mel, 16, kind)
        rank, info = S.kmeans_rank(stat, 5)
        want_rank, want_info = JS.kmeans_rank(stat, 5)
        np.testing.assert_array_equal(rank, want_rank)
        assert len(info) == len(want_info)
        for (mn, mx, share), (wmn, wmx, wshare) in zip(info, want_info):
            assert abs(mn - wmn) <= 1e-6 and abs(mx - wmx) <= 1e-6
            assert share == wshare


def test_patch_stats_matches_jax_and_torch_rearrange(rng):
    from einops import rearrange

    mel = rng.normal(size=(2, 1, 64, 32)).astype(np.float32)
    r = rearrange(torch.from_numpy(mel), "b c (h p) (w q) -> b (c p q) (h w)",
                  p=16, q=16, h=4)
    for kind, want in (("mean", r.mean(dim=1)), ("std", r.std(dim=1))):
        got = S.patch_stats_np(mel, 16, kind)
        np.testing.assert_array_equal(got, JS.patch_stats_np(mel, 16, kind))
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4)


def test_apply_patch_mask_matches_jax(rng):
    img = rng.normal(size=(2, 3, 64, 32)).astype(np.float32)
    idx = np.stack([[0, 3, 7], [1, 2, 5]]).astype(np.int64)
    got = S.apply_patch_mask(img, idx, 16)
    np.testing.assert_array_equal(got, JS.apply_patch_mask(img, idx, 16))
    kept = np.zeros((2, 8), bool)
    kept[[0, 0, 0, 1, 1, 1], idx.ravel()] = True
    grid = got.reshape(2, 3, 4, 16, 2, 16).transpose(0, 2, 4, 1, 3, 5)
    assert (np.abs(grid.reshape(2, 8, -1)).sum(-1) > 0).tolist() == kept.tolist()


def test_compose_melspec_idx():
    stage0 = np.array([[5, 1, 3, 0]])
    stage1 = np.array([[2, 0]])
    out = S.compose_melspec_idx([stage0, stage1])
    np.testing.assert_array_equal(out[0], stage0)
    np.testing.assert_array_equal(out[1], [[3, 5]])


def test_compose_topk_indices():
    """Mirror of tests/test_pruning_ops.py::test_compose_topk_indices, and
    three stages against the JAX function."""
    idx0 = torch.tensor([[4, 2, 0, 3]])
    idx1 = torch.tensor([[2, 0]])
    assert pruning.compose_topk_indices([idx0, idx1]).tolist() == [[0, 4]]
    g = np.random.default_rng(0)
    stages = [np.argsort(g.normal(size=(3, n)), axis=1)[:, :k]
              for n, k in ((20, 14), (14, 9), (9, 5))]
    got = pruning.compose_topk_indices([torch.from_numpy(s) for s in stages])
    want = jpruning.compose_topk_indices([jnp.asarray(s) for s in stages])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _write_feature_dir(path, rng, writer_cls=FeatureWriter, b=4, t=64, f=32):
    writer = writer_cls(str(path))
    mel = rng.normal(size=(b, 1, t, f)).astype(np.float32)
    n = (t // 16) * (f // 16)
    for bidx in range(2):
        half = slice(bidx * b // 2, (bidx + 1) * b // 2)
        writer({
            "mel": mel[half],
            "block-0.attn_score": rng.normal(size=(b // 2, n)).astype(np.float32),
            "block-1.attn_score": rng.normal(size=(b // 2, n)).astype(np.float32),
            "block-1.topk_idx": np.argsort(-rng.normal(size=(b // 2, n)), axis=1)
            [:, : n // 2].astype(np.int64),
            "labels": ["a", "b"][: b // 2] * (b // 4 or 1),
        }, bidx)
    return mel, n


def test_feature_roundtrip_and_kendall_cli(tmp_path, rng):
    mel, n = _write_feature_dir(tmp_path, rng)
    assert sorted(os.listdir(tmp_path))[0] == "block-0.attn_score.0000.pth"
    np.testing.assert_array_equal(combine_feature_dict(str(tmp_path), "mel"), mel)
    assert combine_feature_dict(str(tmp_path), "labels") == ["a", "b", "a", "b"]
    assert combine_feature_dict(str(tmp_path), "block-7.topk_idx") is None
    taus, info = extract_stats.kendall_rank(str(tmp_path), str(tmp_path / "out"),
                                            "mean", num_blocks=2)
    assert len(taus) == 2 and all(-1 <= x <= 1 for x in taus)
    assert len(info) == 5
    count = extract_stats.retained_token_analyze(str(tmp_path))
    assert 0 <= count <= 4 * n // 2


def _write_constant_patch_corpus(dirpath, bands, patch=16, grid=(8, 8)):
    """Feature dir whose per-patch means are 5 separated bands (KMeans(5)
    recovers them), with scores whose taus are known (as in
    tests/test_analysis.py)."""
    h, w = grid
    n = h * w
    b = bands.shape[0]
    jrng = np.random.default_rng(12345)
    mel = np.zeros((b, 1, h * patch, w * patch), dtype=np.float32)
    for bi in range(b):
        for p in range(n):
            r, c = divmod(p, w)
            jitter = jrng.normal(0, 1e-3, size=(patch, patch))
            jitter -= jitter.mean()
            mel[bi, 0, r * patch:(r + 1) * patch, c * patch:(c + 1) * patch] = (
                bands[bi, p] * 10.0 - 20.0 + jitter)
    score0 = bands * 1.0 + np.arange(n)[None, :] * 1e-4
    keep = n // 2
    topk0 = np.argsort(-score0, axis=1, kind="stable")[:, :keep].astype(np.int64)
    gathered_band = np.take_along_axis(bands, topk0, axis=1)
    score1 = -(gathered_band * 1.0) - np.arange(keep)[None, :] * 1e-4
    FeatureWriter(str(dirpath))({
        "mel": mel,
        "block-0.attn_score": score0.astype(np.float32),
        "block-0.topk_idx": topk0,
        "block-1.attn_score": score1.astype(np.float32),
        "labels": ["x"] * b,
    }, 0)
    return score0, score1, gathered_band


def test_kendall_pipeline_quantitative_golden(tmp_path, rng):
    bands = rng.integers(0, 5, size=(6, 64)).astype(np.float64)
    _s0, score1, gathered_band = _write_constant_patch_corpus(tmp_path, bands)
    taus, info = extract_stats.kendall_rank(
        str(tmp_path), str(tmp_path / "out"), "mean", fig_title="SYN",
        num_blocks=2)
    assert taus[0] == 1.0
    assert abs(taus[1] - brute_force_tau(score1, gathered_band)) < 1e-9
    np.testing.assert_allclose(sorted(i[0] for i in info), [-20, -10, 0, 10, 20],
                               atol=1e-4)


def test_kendall_json_schema_and_merge(tmp_path, rng):
    """The {dataset: [tau x blocks]} schema of the reference's published
    stats/kendall_rank_*.json, merged across per-dataset runs; an entry of
    another block count is dropped as stale; draw_kendall_graph reads it."""
    bands = rng.integers(0, 5, size=(4, 64)).astype(np.float64)
    _write_constant_patch_corpus(tmp_path / "feats", bands)
    out = tmp_path / "out"
    out.mkdir()
    (out / "kendall_rank_mean.json").write_text(json.dumps({"OLD": [0.1] * 12}))
    for title in ("ESC-50", "SPC-2"):
        extract_stats.kendall_rank(str(tmp_path / "feats"), str(out), "mean",
                                   fig_title=title, num_blocks=2)
    ours = json.loads((out / "kendall_rank_mean.json").read_text())
    assert set(ours) == {"ESC-50", "SPC-2"}
    assert all(isinstance(v, list) and len(v) == 2
               and all(isinstance(t, float) for t in v) for v in ours.values())
    path = reducers.draw_kendall_graph(str(out / "kendall_rank_mean.json"),
                                       out_path=str(tmp_path / "k.jpg"))
    assert os.path.getsize(path) > 0


def test_visualize_subcommands_write_images(tmp_path, rng):
    bands = rng.integers(0, 5, size=(3, 64)).astype(np.float64)
    _write_constant_patch_corpus(tmp_path / "feats", bands)
    out = extract_stats.visualize_mask(str(tmp_path / "feats"),
                                       str(tmp_path / "viz"), num_items=3)
    imgs = os.listdir(out)
    assert any("input" in p for p in imgs)
    assert any(p.endswith("_0.jpg") for p in imgs)
    path = extract_stats.retained_token_visualize(
        str(tmp_path / "feats"), str(tmp_path / "viz"), fig_title="syn")
    assert os.path.exists(path) and os.path.getsize(path) > 0


def test_reducers(tmp_path, monkeypatch):
    for fold in range(3):
        d = tmp_path / f"fold{fold}"
        d.mkdir()
        (d / f"best-00{fold}-{90 + fold}.0000.txt").touch()
    assert abs(reducers.average_scores(str(tmp_path)) - 91.0) < 1e-9
    # the aggregate written into the tree is not counted on a rerun
    assert abs(reducers.average_scores(str(tmp_path)) - 91.0) < 1e-9
    j = tmp_path / "k.json"
    j.write_text(json.dumps({"ESC-50": list(np.linspace(0, 1, 12))}))
    monkeypatch.setattr(sys, "argv", ["reducers", str(j), "--kendall_plot"])
    reducers.main()
    assert os.path.exists(f"{j}.jpg")


def test_average_csv_results(tmp_path):
    for fold, acc in enumerate([0.90, 0.92, 0.94]):
        d = tmp_path / f"fold-{fold}"
        d.mkdir()
        np.savetxt(d / "best_result.csv", [fold, acc], delimiter=",")
    assert abs(reducers.average_csv_results(str(tmp_path)) - 0.92) < 1e-9
    assert len([p for p in os.listdir(tmp_path)
                if p.startswith("average_result_")]) == 1


def test_numeric_subcommands_run_without_sklearn_and_matplotlib(tmp_path, rng,
                                                                 monkeypatch,
                                                                 capsys):
    """With scikit-learn and matplotlib unimportable (the card's image has
    neither), --kendall_rank_mean, --kendall_rank_std and
    --retained_token_analyze run through main(), and so does the reducer's
    average."""
    _write_feature_dir(tmp_path / "feats", rng, b=8)
    for name in ("sklearn", "sklearn.cluster", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    base = ["--feature_dict_path", str(tmp_path / "feats"),
            "--output_dir", str(tmp_path / "out")]
    for flag in ("--kendall_rank_mean", "--kendall_rank_std",
                 "--retained_token_analyze"):
        extract_stats.main(base + [flag, "--fig_title", "T"])
    printed = capsys.readouterr().out
    assert "Kendall Rank for block 1" in printed
    assert int(printed.strip().splitlines()[-1]) >= 0
    for stat in ("mean", "std"):
        taus = json.loads((tmp_path / "out" / f"kendall_rank_{stat}.json")
                          .read_text())["T"]
        assert len(taus) == 2 and all(np.isfinite(taus))
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "best-003-88.5000.txt").touch()
    reducers.main([str(tmp_path / "exp")])
    assert sys.modules["sklearn"] is None and sys.modules["matplotlib"] is None


def test_extract_stats_kendall_json_matches_jax(tmp_path):
    """One feature directory (written by the JAX package's writer, read by
    both): the JAX package's extract_stats (scikit-learn's KMeans) and the
    port's (its numpy KMeans) write the same Kendall JSON, per stat, and
    count the same retained tokens."""
    g = np.random.default_rng(7)
    mel = _mels(7, 12, 128, 64)
    n = 8 * 4
    writer = JaxFeatureWriter(str(tmp_path / "feats"))
    idx1 = np.stack([g.permutation(n)[:23] for _ in range(12)]).astype(np.int64)
    idx2 = np.stack([g.permutation(23)[:16] for _ in range(12)]).astype(np.int64)
    for b in range(3):
        rows = slice(4 * b, 4 * b + 4)
        writer({"mel": mel[rows],
                "block-0.attn_score": g.normal(size=(4, n)).astype(np.float32),
                "block-1.attn_score": g.normal(size=(4, n)).astype(np.float32),
                "block-1.topk_idx": idx1[rows],
                "block-2.attn_score": g.normal(size=(4, 23)).astype(np.float32),
                "block-2.topk_idx": idx2[rows],
                "block-3.attn_score": g.normal(size=(4, 16)).astype(np.float32),
                "labels": ["c"] * 4}, b)
    feats = str(tmp_path / "feats")
    for flag, stat in (("--kendall_rank_mean", "mean"), ("--kendall_rank_std", "std")):
        extract_stats.main(["--feature_dict_path", feats, "--output_dir",
                            str(tmp_path / "port"), flag, "--fig_title", "ESC"])
        jextract.main(["--feature_dict_path", feats, "--output_dir",
                       str(tmp_path / "jax"), flag, "--fig_title", "ESC"])
        got = json.loads((tmp_path / "port" / f"kendall_rank_{stat}.json").read_text())
        want = json.loads((tmp_path / "jax" / f"kendall_rank_{stat}.json").read_text())
        assert got == want and len(got["ESC"]) == 4
    assert (extract_stats.retained_token_analyze(feats)
            == jextract.retained_token_analyze(feats))
