"""The port's serving artifacts (tpat_tpu_torch.utils.serving, cli) against
the JAX package's: the same params.npz/meta.json layout, the same bucketed
dispatch, on the CPU."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import ViTConfig, audiomae_vit_tiny
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu.utils import serving as jserving
from tpat_tpu_torch.cli import export_serving, profile_forward
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.ops.frontend import FrontendConfig, device_frontend
from tpat_tpu_torch.utils import serving
from tpat_tpu_torch.utils.weights import (
    jax_flat_from_state_dict,
    load_pth,
    state_dict_from_jax,
)

CFG = ViTConfig(
    compute_dtype="float32", embed_dim=64, depth=3, num_heads=2, num_classes=5,
    target_length=64, num_mel_bins=32, drop_loc=(1,), base_keep_rate=0.6,
    drop_path_rate=0.0,
)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX model of test_serving_export_bucketed with sharpened params
    (qkv N(0, 1), the rest N(0, 0.05^2)), so top-k is well conditioned
    across frameworks."""
    model = JaxAudioViT(CFG)
    init = model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, 64, 32))
    )["params"]
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        scale = 1.0 if "qkv" in name else 0.05
        return (rng.normal(size=np.shape(leaf)) * scale).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, init)


def test_jax_artifact_served_by_port(jax_pair, tmp_path):
    """A bucketed artifact written by the JAX exporter, served by the port:
    logits equal JAX model.apply for every request size (pad -> 2, exact,
    pad -> 4, exact, chunk 4 + 3) within the f32 parity tolerance of
    test_audiomae_flavor_parity (rtol 1e-3, atol 2e-4)."""
    model, params = jax_pair
    out = jserving.export_forward(
        model, params, (1, 1, 64, 32), str(tmp_path / "artifact"),
        batch_sizes=(4, 2),
    )
    with pytest.raises(ValueError, match="vit_config"):
        serving.load_forward(out, device="cpu")
    fn, meta = serving.load_forward(out, cfg=CFG, device="cpu")
    assert meta["batch_sizes"] == [2, 4]
    x = np.random.default_rng(1).normal(size=(7, 1, 64, 32)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    for n in (1, 2, 3, 4, 7):  # samples are independent: a prefix per request
        got = fn(x[:n])
        assert got.shape == (n, 5) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[:n], rtol=1e-3, atol=2e-4)


def test_port_export_load_round_trip(jax_pair, tmp_path):
    """Port export -> port load: bucketed logits equal the live model's
    per-request forward exactly (padding rows never cross samples)."""
    _, params = jax_pair
    model = AudioViT(CFG)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    out = serving.export_forward(
        model, (1, 1, 64, 32), str(tmp_path / "a"), batch_sizes=(4, 2)
    )
    meta = json.loads((tmp_path / "a" / "meta.json").read_text())
    assert meta["input_shape"] == [None, 1, 64, 32]
    assert meta["input_dtype"] == "float32" and meta["batch_sizes"] == [2, 4]
    fn, _ = serving.load_forward(out, device="cpu")  # config from meta
    rng = np.random.default_rng(2)
    for n in (1, 3, 7):
        x = torch.from_numpy(rng.normal(size=(n, 1, 64, 32)).astype(np.float32))
        with torch.no_grad():
            want = torch.cat([model(x[i:i + 1]) for i in range(n)])
        torch.testing.assert_close(fn(x), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros(1, 1, 32, 64))
    # an unbucketed artifact is fixed to its batch
    fixed = serving.export_forward(model, (3, 1, 64, 32), str(tmp_path / "b"))
    fn3, meta3 = serving.load_forward(fixed, device="cpu")
    assert meta3["input_shape"] == [3, 1, 64, 32] and "batch_sizes" not in meta3
    assert fn3(torch.zeros(3, 1, 64, 32)).shape == (3, 5)
    with pytest.raises(ValueError, match="fixed"):
        fn3(torch.zeros(2, 1, 64, 32))


def test_flat_params_round_trip(jax_pair):
    _, params = jax_pair
    params = jax.tree_util.tree_map(np.asarray, params)
    got = jax_flat_from_state_dict(state_dict_from_jax(params))
    want = jserving._flatten(params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


def test_cli_help_and_export_from_pth(tmp_path):
    buf = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(buf):
        export_serving.cli(["--help"])
    assert exc.value.code == 0 and "--finetuned_model_path" in buf.getvalue()

    cfg = audiomae_vit_tiny(
        num_classes=3, target_length=32, drop_loc=(3, 4), base_keep_rate=0.7,
        drop_path_rate=0.0, compute_dtype="bfloat16",
    )
    model = AudioViT(cfg, generator=torch.Generator().manual_seed(1))
    pth = tmp_path / "tiny.pth"
    torch.save({"model": model.state_dict(), "epoch": 3}, pth)
    assert set(load_pth(str(pth))) == set(model.state_dict())
    argv = [
        "--model", "audiomae_vit_tiny", "--nb_classes", "3",
        "--target_length", "32", "--drop_loc", "(3, 4)",
        "--base_keep_rate", "0.7", "--finetuned_model_path", str(pth),
        "--batch_size", "1,2", "--out_dir", str(tmp_path / "art"),
    ]
    with contextlib.redirect_stdout(io.StringIO()):
        export_serving.cli(argv)
    fn, meta = serving.load_forward(str(tmp_path / "art"), device="cpu")
    assert meta["vit_config"]["compute_dtype"] == "bfloat16"
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(3, 1, 32, 128)).astype(np.float32)
    )
    with torch.no_grad():  # the dispatch: bucket 2, then bucket 1
        want = torch.cat([model.eval()(x[:2]), model(x[2:])])
    torch.testing.assert_close(fn(x), want, rtol=0, atol=0)

    with pytest.raises(SystemExit):
        export_serving.cli(argv + ["--batch_size", "0"])
    # --device_frontend (refused until the device frontend was ported) now
    # writes a waveform artifact: raw PCM of 400 + 31 * 160 samples, the
    # esc50 preset's normalisation, the frontend before the model
    wave_dir = str(tmp_path / "wave")
    wave_argv = argv[:-1] + [wave_dir, "--device_frontend"]
    with contextlib.redirect_stdout(io.StringIO()):
        export_serving.cli(wave_argv)
    wfn, wmeta = serving.load_forward(wave_dir, device="cpu")
    assert wmeta["frontend"]["input"] == "waveform"
    assert wmeta["input_shape"] == [None, 5360]
    wav = np.random.default_rng(3).normal(size=(3, 5360)).astype(np.float32) * 0.1
    wav[2, 3000:] = np.nan  # a short clip: the NaN-tail contract
    fcfg = FrontendConfig(target_length=32, norm_mean=-6.6268077,
                          norm_std=5.358466)
    with torch.no_grad():  # the dispatch: bucket 2, then bucket 1
        want = torch.cat([model(device_frontend(torch.from_numpy(w), fcfg))
                          for w in (wav[:2], wav[2:])])
    torch.testing.assert_close(wfn(wav), want, rtol=0, atol=0)
    orbax = argv.copy()
    orbax[orbax.index(str(pth))] = str(tmp_path / "best_model")
    with pytest.raises(SystemExit, match="tpat-convert"):
        export_serving.cli(orbax)


def test_profile_forward_help_and_needs_cuda():
    """The forward profiler is a card-only tool: it answers --help and
    refuses to run on a machine without CUDA instead of timing the CPU."""
    buf = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(buf):
        profile_forward.cli(["--help"])
    assert exc.value.code == 0 and "--buckets" in buf.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            profile_forward.cli([])
