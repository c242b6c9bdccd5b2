"""The port's device frontend (tpat_tpu_torch.ops.fbank.fbank_torch,
ops/frontend.py), its waveform datasets and its waveform serving artifacts
against the JAX package's, on the CPU, in f32.

Tolerances: ``fbank_torch`` (torch's pocketfft) against ``fbank_jax``
(XLA's FFT) within rtol 1e-3 and atol 2e-3 of the log-mel, the tolerance
the JAX package holds its device frontend to the host fbank with
(tests/test_frontend.py:34, :57): two f32 FFTs round each bin's power in
another order, and the log turns the relative error of a power near
float32's eps into an absolute one (measured: 4.4e-4 at most on these
clips).  After the normalisation (/ 2 std) the same rounding is ten times
smaller.  The SpecAug masks are compared bit for bit, from JAX's draws."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu import config as jcfg
from tpat_tpu.data import datasets as jds
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu.ops import fbank as jfb
from tpat_tpu.ops import frontend as jfe
from tpat_tpu.utils import serving as jserving
from tpat_tpu_torch import config as cfg_lib
from tpat_tpu_torch.data import datasets as ds_lib
from tpat_tpu_torch.data import wav as wav_lib
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.ops import fbank as fb
from tpat_tpu_torch.ops import frontend as fe
from tpat_tpu_torch.utils import serving
from tpat_tpu_torch.utils.weights import state_dict_from_jax

RTOL, ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def waves():
    g = np.random.default_rng(0)
    return np.clip(g.normal(size=(3, 16000)) * 0.2, -1, 1).astype(np.float32)


def _configs(**kw):
    return fe.FrontendConfig(**kw), jfe.FrontendConfig(**kw)


def test_fbank_torch_matches_fbank_jax(waves):
    got = fb.fbank_torch(torch.from_numpy(waves))
    want = np.asarray(jfb.fbank_jax(jnp.asarray(waves)))
    assert got.shape == (3, 98, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # one clip, unbatched, and the host fbank
    one = fb.fbank_torch(torch.from_numpy(waves[1]))
    np.testing.assert_allclose(one.numpy(), fb.fbank_numpy(waves[1]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["full", "cropped", "nan_tail", "nan_head"])
def test_device_frontend_eval_matches_jax(waves, case):
    """Eval mode: a clip of exactly ``num_samples``, a clip cropped to a
    shorter target, a short clip with a NaN tail and one with a VoxCeleb
    NaN head of 10 frames (1600 samples)."""
    target = 64 if case == "cropped" else 128
    cfg, jc = _configs(target_length=target, norm_mean=-6.0, norm_std=5.0)
    n = (target - 1) * 160 + 400
    long = np.tile(waves, (1, 2))
    if case == "cropped":
        batch = waves  # 98 frames cropped to 64
    else:
        batch = np.full((3, n), np.nan, dtype=np.float32)
        for i in range(3):
            if case == "full":
                batch[i] = long[i, :n]
            elif case == "nan_tail":
                m = (9000, 5000, 12345)[i]
                batch[i, :m] = long[i, :m]
            else:
                m = (9000, 5000, 400)[i]
                batch[i, 1600:1600 + m] = long[i, :m]
    got = fe.device_frontend(torch.from_numpy(batch), cfg)
    want = np.asarray(jax.jit(lambda w: jfe.device_frontend(w, jc))(batch))
    assert got.shape == (3, 1, target, 128)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL / 10)


def _jax_draws(rng, b, cfg: jfe.FrontendConfig):
    """The uniforms JAX's train-mode device_frontend draws from ``rng``
    (``tpat_tpu/ops/frontend.py:146-170``), under the port's names."""
    draws = {}
    rng, sub = jax.random.split(rng)
    if cfg.freqm or cfg.timem:
        r1, r2, r3, r4 = jax.random.split(sub, 4)
        draws.update(freq_width=jax.random.uniform(r1, (b,)),
                     freq_start=jax.random.uniform(r2, (b,)),
                     time_width=jax.random.uniform(r3, (b,)),
                     time_start=jax.random.uniform(r4, (b,)))
    if cfg.noise:
        r1, r2, r3 = jax.random.split(rng, 3)
        draws.update(noise_scale=jax.random.uniform(r2, (b,)) / 10.0,
                     noise=jax.random.uniform(r1, (b, cfg.target_length,
                                                   cfg.num_mel_bins)),
                     roll=jax.random.randint(r3, (b,), -10, 10))
    return draws, sub


@pytest.mark.parametrize("freqm,timem", [(24, 48), (48, 200), (2, 0)])
def test_spec_masking_with_jax_draws_is_bit_equal(freqm, timem):
    """The port's SpecAug fed JAX's uniforms masks the same bins as JAX's,
    bit for bit (at 48 > F = 32 and 200 > T = 64 too: param is not
    clamped)."""
    for seed in range(6):
        sub = jax.random.PRNGKey(seed)
        r1, r2, r3, r4 = jax.random.split(sub, 4)
        draws = {k: torch.tensor(np.asarray(jax.random.uniform(r, (8,))))
                 for k, r in zip(("freq_width", "freq_start", "time_width",
                                  "time_start"), (r1, r2, r3, r4))}
        mel = np.ones((8, 64, 32), np.float32)
        want = np.asarray(jfe._spec_masking_device(jnp.asarray(mel), freqm,
                                                   timem, sub))
        got = fe._spec_masking_device(torch.from_numpy(mel), freqm, timem, draws)
        np.testing.assert_array_equal(got.numpy(), want)


def test_train_frontend_with_jax_draws_matches_jax(waves):
    """Train mode with SpecAug and noise: the port fed every JAX draw (band
    uniforms, the noise, its per-clip scale and roll) against JAX's
    device_frontend on the same key."""
    cfg, jc = _configs(target_length=128, norm_mean=-6.0, norm_std=5.0,
                       freqm=24, timem=48, noise=True)
    n = 127 * 160 + 400
    batch = np.tile(waves, (1, 2))[:, :n]
    key = jax.random.PRNGKey(3)
    draws, _ = _jax_draws(key, 3, jc)
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    got = fe.device_frontend(torch.from_numpy(batch), cfg, train=True,
                             draws=draws)
    want = np.asarray(jax.jit(
        lambda w, r: jfe.device_frontend(w, jc, rng=r, train=True))(batch, key))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL / 10)


def test_device_spec_masking_floor_semantics():
    """Mirror of tests/test_frontend.py: at param 2 a band is 0 or 1 bins
    wide, never 2 (start and width truncated separately), and both occur."""
    mel = torch.ones(8, 16, 16)
    cfg = fe.FrontendConfig(freqm=2, target_length=16, num_mel_bins=16)
    widths = set()
    for seed in range(40):
        draws = fe.frontend_draws(8, cfg, torch.Generator().manual_seed(seed))
        out = fe._spec_masking_device(mel, 2, 0, draws)
        for b in range(8):
            zero_cols = int((out[b] == 0.0).all(dim=0).sum())
            widths.add(zero_cols)
            assert zero_cols <= 1, zero_cols
    assert widths == {0, 1}


def test_device_noise_aug_per_sample():
    """Mirror of tests/test_frontend.py: the noise scale and the time roll
    are drawn per clip, so eight identical clips come out different."""
    cfg = fe.FrontendConfig(target_length=64, norm_mean=0.0, norm_std=0.5,
                            noise=True)
    waves = np.tile(
        np.clip(np.random.default_rng(0).normal(size=(1, 16000)) * 0.2, -1, 1),
        (8, 1)).astype(np.float32)
    out = fe.device_frontend(torch.from_numpy(waves), cfg,
                             torch.Generator().manual_seed(0), train=True)
    diffs = [(out[i] - out[0]).abs().max() > 1e-4 for i in range(1, 8)]
    assert sum(diffs) >= 6, diffs
    with pytest.raises(ValueError, match="Generator"):
        fe.device_frontend(torch.from_numpy(waves), cfg, train=True)


@pytest.fixture(scope="module")
def voxceleb_tree(tmp_path_factory):
    """Clips shorter than the 128-frame target (lr_pad draws a NaN head),
    one longer (cropped)."""
    root = tmp_path_factory.mktemp("torch_vox_wave")
    rng = np.random.default_rng(1)
    lines = []
    for s, spk in enumerate(["id10001", "id10003"]):
        (root / "wav" / spk / "c").mkdir(parents=True)
        for u, secs in enumerate((0.6, 0.9, 1.5)):
            rel = f"{spk}/c/{u:05d}.wav"
            n = int(16000 * secs)
            w = 0.3 * np.sin(2 * np.pi * (200 + 90 * s) * np.arange(n) / 16000)
            wav_lib.save_wav(str(root / "wav" / rel),
                             (w + 0.01 * rng.normal(size=n)).astype(np.float32),
                             16000)
            lines.append(f"{1 if u < 2 else 3} {rel}")
    (root / "iden_split.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("subset", ["train", "test"])
def test_voxceleb_waveform_items_match_jax(voxceleb_tree, subset):
    """The waveform mode's arrays (NaN head and tail positions included)
    bit for bit equal to tpat_tpu.data.datasets' under one seed, over two
    epochs (lr_pad's draw per epoch, roll-magnitude on)."""
    kw = dict(name="v", num_classes=2, target_length=128, norm_mean=-6.0,
              norm_std=5.0, multilabel=False, use_noise=True, loss_type="ce",
              roll_mag_aug=True)
    args = dict(lr_pad=True, seed=4, return_waveform=True)
    mine = ds_lib.VoxCeleb1Dataset(voxceleb_tree, subset,
                                   cfg_lib.DataConfig(**kw), **args)
    theirs = jds.VoxCeleb1Dataset(voxceleb_tree, subset, jcfg.DataConfig(**kw),
                                  **args)
    assert mine.num_samples == theirs.num_samples == 127 * 160 + 400
    heads = set()
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(mine)):
            (x, y, rel), (wx, wy, wrel) = mine[i], theirs[i]
            assert x.shape == (mine.num_samples,) and x.dtype == np.float32
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
            assert rel == wrel
            heads.add(int(np.argmax(np.isfinite(x))))
    if subset == "train":
        assert len(heads) > 1 and all(h % 160 == 0 for h in heads)


CFG_KW = dict(compute_dtype="float32", embed_dim=64, depth=3, num_heads=2,
              num_classes=4, target_length=64, num_mel_bins=128,
              drop_loc=(1,), base_keep_rate=0.6, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def jax_model():
    """A JAX model with sharpened params and a waveform batch: two full
    clips, one with a NaN tail, one with a NaN head."""
    cfg = jcfg.ViTConfig(**CFG_KW)
    model = JaxAudioViT(cfg)
    init = model.init({"params": jax.random.PRNGKey(1)},
                      jnp.zeros((1, 1, 64, 128)))["params"]
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        return (rng.normal(size=np.shape(leaf)) * (1.0 if "qkv" in name else 0.05)
                ).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, init)
    n = 400 + 63 * 160
    wav = (rng.normal(size=(4, n)) * 0.1).astype(np.float32)
    wav[2, n // 2:] = np.nan
    wav[3, :1600] = np.nan
    return model, params, wav


def test_jax_waveform_artifact_served_by_port(jax_model, tmp_path):
    """A bucketed waveform artifact written by the JAX exporter, served by
    the port (its frontend, then the model): logits within the f32 parity
    tolerance of JAX's own loader on every request size (zero-row bucket
    padding, chunking)."""
    model, params, wav = jax_model
    fcfg = jfe.FrontendConfig(num_mel_bins=128, target_length=64)
    out = jserving.export_forward(model, params, (1, wav.shape[1]),
                                  str(tmp_path / "jax_art"), batch_sizes=(1, 2),
                                  frontend=fcfg)
    jfn, _ = jserving.load_forward(out)
    fn, meta = serving.load_forward(out, cfg=cfg_lib.ViTConfig(**CFG_KW),
                                    device="cpu")
    assert meta["frontend"]["input"] == "waveform"
    for n in (1, 3, 4):
        got = fn(wav[:n])
        assert got.shape == (n, 4) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(wav[:n])),
                                   rtol=1e-3, atol=2e-4)


def test_port_waveform_artifact_matches_jax_frontend_and_model(jax_model, tmp_path):
    """A waveform artifact written by the port: the same meta schema as the
    JAX exporter's, and its served logits against JAX's device_frontend
    then model.apply on the same weights."""
    jmodel, params, wav = jax_model
    model = AudioViT(cfg_lib.ViTConfig(**CFG_KW))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    fcfg = fe.FrontendConfig(num_mel_bins=128, target_length=64)
    out = serving.export_forward(model.eval(), (2, wav.shape[1]),
                                 str(tmp_path / "port_art"), batch_sizes=(2, 4),
                                 frontend=fcfg)
    meta = json.loads((tmp_path / "port_art" / "meta.json").read_text())
    jserving.export_forward(jmodel, params, (2, wav.shape[1]),
                                   str(tmp_path / "jax_art"),
                                   frontend=jfe.FrontendConfig(num_mel_bins=128,
                                                               target_length=64))
    jmeta = json.loads((tmp_path / "jax_art" / "meta.json").read_text())
    assert meta["frontend"] == jmeta["frontend"]
    fn, _ = serving.load_forward(out, device="cpu")
    spec = jfe.device_frontend(jnp.asarray(wav), jfe.FrontendConfig(
        num_mel_bins=128, target_length=64))
    want = np.asarray(jmodel.apply({"params": params}, spec))
    got = fn(wav)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)
