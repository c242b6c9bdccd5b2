"""Masked autoencoder for spectrograms, the pretraining model (port of
``tpat_tpu/models/mae.py``).

A ViT encoder on the visible patches and a decoder over the de-shuffled
full sequence, with a masked-patch MSE loss (optionally against per-patch
normalised pixels).  Masking flavours (``mae.py:486-535``):

- ``random_masking``: keep ``int(L * (1 - ratio))`` tokens by argsort of
  per-token noise;
- ``random_masking_2d``: drop whole time rows and frequency columns of the
  patch grid; the kept ids come from the ``max(999, t*f)``-offset argsort.

Both take their noise as tensors, so a test can hand the port the JAX
package's noise; the forward draws it from the caller's ``torch.Generator``
when none is given, at the global batch's shape under data parallelism,
cut to the rank's rows (``parallel/mesh.py``).

Decoders (``decoder_mode``):

- 0: plain transformer blocks (``models/vit.py::Block`` at keep 1.0,
  xavier-uniform linears) over [CLS + the unshuffled tokens]; the
  prediction drops the CLS row (``mae.py:453-457, 576-588``).  At the
  reference decoder (512 wide, 16 heads) their attention runs the
  packed-qkv kernels (``ops/qkv_attention.py``) at head_dim 32, without
  scores.
- 1: 16 swin_v2_cr blocks (timm's ``SwinTransformerV2CrBlock`` as the
  reference constructs it) over the patch grid, with scaled cosine
  attention, clamped learned per-head logit scales, a log-CPB meta-MLP
  relative-position bias (with its hidden dropout of 0.125 in training)
  and V2 res-post-norm residuals.  ``window_attention_impl`` picks the
  attention: 'fused' (the dense kernel, ``ops/window_attention.py``),
  'banded' (the block-diagonal kernel in window-major order), 'xla' (the
  partitioned-window reference path, in plain PyTorch), or 'auto', which
  takes dense where the JAX package's criterion admits it (the ESC-50
  grid, N = 256), else banded (the AudioSet grid, N = 512), else 'xla'.

The encoder blocks are ``models/vit.py::Block`` at keep 1.0, so they run the
attention kernels of the finetune path with no scores.  Parameter names are
the reference pretraining model's ``.pth`` keys (``utils/weights.py::
mae_state_dict``), so a state dict exported from the JAX package loads with
``strict=True``.  Precision follows the JAX package: f32 parameters cast to
the compute dtype at use, f32 LayerNorm statistics, the cosine and softmax
math in f32, an f32 prediction head and loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.models.pos_embed import sincos_2d
from tpat_tpu_torch.models.vit import (
    Block, LayerNorm, Linear, Mlp, PatchEmbed, xavier_uniform_,
)
from tpat_tpu_torch.ops import window_attention as wa
from tpat_tpu_torch.ops.pruning import take_rows
from tpat_tpu_torch.parallel.mesh import rand_rows

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
META_DROPOUT = 0.125  # timm's meta_mlp drop=(0.125, 0.)
Noise = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 16
    decoder_num_heads: int = 16
    decoder_mode: int = 1  # 0 = transformer, 1 = shifted-window
    window_size: Tuple[int, int] = (4, 4)
    mlp_ratio: float = 4.0
    patch_size: int = 16
    target_length: int = 1024
    num_mel_bins: int = 128
    norm_pix_loss: bool = False
    mask_2d: bool = False
    mask_t_prob: float = 0.7
    mask_f_prob: float = 0.3
    compute_dtype: str = "bfloat16"
    # 'auto': the dense kernel where the JAX package's criterion
    # (ops/window_attention.py::supports) admits it, else the banded one,
    # else the partitioned reference path; 'fused'/'banded'/'xla' force one.
    window_attention_impl: str = "auto"
    gelu_impl: str = "auto"
    # models_mae.py:33,55,69: the sin-cos pos embeds are frozen (no
    # gradient, no weight decay) unless pos_trainable.
    pos_trainable: bool = False

    def __post_init__(self):
        if self.window_attention_impl not in ("auto", "fused", "banded", "xla"):
            raise ValueError(
                "window_attention_impl must be 'auto', 'fused', 'banded', "
                f"or 'xla', got {self.window_attention_impl!r}"
            )
        if self.gelu_impl not in ("auto", "exact", "poly"):
            raise ValueError(
                "gelu_impl must be 'auto', 'exact', or 'poly', "
                f"got {self.gelu_impl!r}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "compute_dtype must be 'float32' or 'bfloat16', "
                f"got {self.compute_dtype!r}"
            )

    @property
    def grid(self) -> Tuple[int, int]:
        return (
            self.target_length // self.patch_size,
            self.num_mel_bins // self.patch_size,
        )

    @property
    def num_patches(self) -> int:
        t, f = self.grid
        return t * f

    def encoder_vit_config(self) -> ViTConfig:
        return ViTConfig(
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            target_length=self.target_length,
            num_mel_bins=self.num_mel_bins,
            drop_loc=(),
            base_keep_rate=1.0,
            drop_path_rate=0.0,
            compute_dtype=self.compute_dtype,
            gelu_impl=self.gelu_impl,
            dense_init="xavier_uniform",  # models_mae.py:170-173
        )

    def decoder_vit_config(self) -> ViTConfig:
        return ViTConfig(
            embed_dim=self.decoder_embed_dim,
            depth=self.decoder_depth,
            num_heads=self.decoder_num_heads,
            mlp_ratio=self.mlp_ratio,
            target_length=self.target_length,
            num_mel_bins=self.num_mel_bins,
            drop_loc=(),
            base_keep_rate=1.0,
            drop_path_rate=0.0,
            compute_dtype=self.compute_dtype,
            gelu_impl=self.gelu_impl,
            dense_init="xavier_uniform",
        )


def mae_vit_base_dec512d8b(**kw) -> MAEConfig:
    """models_mae.py:438-442 factory geometry.  The reference factory's name
    says d8b but it passes no decoder_depth, so the class default 16
    applies, as in the JAX package."""
    kw.setdefault("decoder_depth", 16)
    return MAEConfig(embed_dim=768, depth=12, num_heads=12,
                     decoder_embed_dim=512, decoder_num_heads=16, **kw)


def _relative_coordinates_log(window: Tuple[int, int]) -> np.ndarray:
    """Log-spaced pairwise window coordinates, (L*L, 2): sign(d) log(1 + |d|)
    in row-major (query, key) pair order (``mae.py:159-169``)."""
    wh, ww = window
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, L, L)
    rel = rel.transpose(1, 2, 0).reshape(-1, 2).astype(np.float32)
    return np.sign(rel) * np.log1p(np.abs(rel))


def _shift_attn_mask(
    feat_size: Tuple[int, int],
    window: Tuple[int, int],
    shift: Tuple[int, int],
) -> Optional[np.ndarray]:
    """Additive (-100) mask of pairs in different shift regions, per window,
    (num_windows, L, L); None when the block is unshifted
    (``mae.py:172-198``)."""
    st, sf = shift
    if not (st or sf):
        return None
    t, f = feat_size
    wh, ww = window
    img = np.zeros((t, f), dtype=np.float32)
    cnt = 0
    for hsl in (slice(0, -wh), slice(-wh, -st), slice(-st, None)):
        for wsl in (slice(0, -ww), slice(-ww, -sf), slice(-sf, None)):
            img[hsl, wsl] = cnt
            cnt += 1
    win = (
        img.reshape(t // wh, wh, f // ww, ww)
        .transpose(0, 2, 1, 3)
        .reshape(-1, wh * ww)
    )
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _need_generator(generator: Optional[torch.Generator], what: str):
    if generator is None:
        raise ValueError(
            f"{what} draws random numbers: pass a torch.Generator on the "
            "model's device as `generator`"
        )
    return generator


class MetaMlp(nn.Module):
    """The log-CPB meta-MLP, 2 -> hidden -> heads, ReLU, f32."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.fc1 = nn.Linear(2, hidden)
        self.fc2 = nn.Linear(hidden, heads)


class WindowAttentionV2(nn.Module):
    """swin_v2_cr window attention (``mae.py:201-323``): scaled cosine
    attention with a clamped learned per-head ``logit_scale`` (init log 10,
    clamp at log 100) and a relative-position bias from the meta-MLP.

    ``forward(x, mask=...)`` is the partitioned reference path: x is
    (num_windows * B, L, C) and mask the (num_windows, L, L) shift mask.
    ``forward(x, geometry=...)`` is the kernel path on the whole grid: x is
    (B, N, C) and ``geometry`` is ``(rows, cols, additive, perm,
    inv_perm)``, the static parts of ``ops/window_attention.py``'s template
    (perm None: the dense kernel) or band (the banded kernel)."""

    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int],
                 compute_dtype: torch.dtype, meta_hidden_dim: int = 384):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = Linear(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)
        self.logit_scale = nn.Parameter(torch.full((num_heads,), math.log(10.0)))
        self.meta_mlp = MetaMlp(meta_hidden_dim, num_heads)
        self.register_buffer(
            "rel_log", torch.from_numpy(_relative_coordinates_log(window)),
            persistent=False,
        )

    def bias_table(
        self, deterministic: bool, generator: Optional[torch.Generator]
    ) -> torch.Tensor:
        """(H, L, L) relative-position bias; the hidden activation drops out
        at 0.125 in training, drawn from ``generator``."""
        h = self.num_heads
        n = self.window[0] * self.window[1]
        hidden = F.relu(self.meta_mlp.fc1(self.rel_log))
        if not deterministic:
            keep = 1.0 - META_DROPOUT
            u = torch.rand(hidden.shape, device=hidden.device,
                           generator=_need_generator(generator, "dropout"))
            hidden = torch.where(u < keep, hidden / keep,
                                 torch.zeros_like(hidden))
        bias = self.meta_mlp.fc2(hidden)
        return bias.transpose(0, 1).reshape(h, n, n)

    def scales(self) -> torch.Tensor:
        """exp(min(logit_scale, log 100)), (H,) f32."""
        return torch.exp(torch.clamp(self.logit_scale, max=math.log(1.0 / 0.01)))

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        geometry: Optional[tuple] = None,
    ) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        scale = self.scales()
        bias = self.bias_table(deterministic, generator)

        if geometry is not None:
            rows, cols, additive, perm, inv_perm = geometry
            tmpl = wa.gather_template(bias, rows, cols, additive)
            if perm is not None:
                out = wa.fused_window_attention_banded(
                    qkv[:, perm], scale, tmpl)[:, inv_perm]
            else:
                out = wa.fused_window_attention(qkv, scale, tmpl)
            return self.proj(out)

        qkv = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        # the cosine and softmax math in f32 whatever the compute dtype
        q = qkv[0].float()
        k = qkv[1].float()
        v = qkv[2]
        qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
        kn = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
        logits = torch.matmul(qn, kn.transpose(-1, -2))
        logits = logits * scale.reshape(1, h, 1, 1) + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = logits.reshape(b // nw, nw, h, n, n) + mask[None, :, None]
            logits = logits.reshape(b, h, n, n)
        p = torch.softmax(logits, dim=-1)
        out = torch.matmul(p.to(v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class SwinBlock(nn.Module):
    """swin_v2_cr shifted-window block over a (T, F) token grid
    (``mae.py:326-404``), V2 res-post-norm: ``x = x + norm1(attn(x))``, then
    ``x = x + norm2(mlp(x))``.  The attention formulation is resolved once,
    here, and its static geometry kept as (non-persistent) buffers."""

    def __init__(self, dec_cfg: ViTConfig, feat_size: Tuple[int, int],
                 window: Tuple[int, int], shift: Tuple[int, int],
                 attn_impl: str = "auto"):
        super().__init__()
        dim, heads = dec_cfg.embed_dim, dec_cfg.num_heads
        dt = _DTYPES[dec_cfg.compute_dtype]
        self.feat_size, self.window, self.shift = feat_size, window, shift
        self.attn = WindowAttentionV2(dim, heads, window, dt)
        self.norm1 = LayerNorm(dim, 1e-6, dt)
        self.mlp = Mlp(dec_cfg)
        self.norm2 = LayerNorm(dim, 1e-6, dt)

        t, f = feat_size
        tokens = t * f
        window_tokens = window[0] * window[1]
        itemsize = torch.empty((), dtype=dt).element_size()
        impl = attn_impl
        if impl == "auto":
            # JAX's layout criterion, and a head_dim the kernels are built
            # for (a call by name at another head_dim raises on CUDA)
            kernels = dim // heads in wa.HEAD_DIMS
            if kernels and wa.supports(heads, dim // heads, tokens, itemsize):
                impl = "fused"
            elif kernels and wa.supports_banded(heads, dim // heads, tokens,
                                                window_tokens, itemsize):
                impl = "banded"
            else:
                impl = "xla"
        self.impl = impl
        mask = _shift_attn_mask(feat_size, window, shift)
        rows = cols = additive = perm = inv_perm = None
        if impl == "fused":
            rows, cols, additive = wa.template_parts(feat_size, window, shift,
                                                     mask)
        elif impl == "banded":
            perm, inv_perm, rows, cols, additive = wa.band_parts(
                feat_size, window, shift, mask)
        buffers = dict(tmpl_rows=rows, tmpl_cols=cols, tmpl_add=additive,
                       perm=perm, inv_perm=inv_perm,
                       attn_mask=mask if impl == "xla" else None)
        for name, a in buffers.items():
            self.register_buffer(
                name, None if a is None else torch.from_numpy(np.asarray(a)),
                persistent=False)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b, l, d = x.shape
        t, f = self.feat_size
        wh, ww = self.window
        st, sf = self.shift
        if l != t * f:
            raise ValueError(f"{l} tokens for a {t} x {f} grid")
        if self.impl != "xla":
            geometry = (self.tmpl_rows, self.tmpl_cols, self.tmpl_add,
                        self.perm, self.inv_perm)
            h = self.attn(x, deterministic=deterministic, generator=generator,
                          geometry=geometry)
        else:
            h = x.reshape(b, t, f, d)
            if st or sf:
                h = torch.roll(h, shifts=(-st, -sf), dims=(1, 2))
            h = h.reshape(b, t // wh, wh, f // ww, ww, d)
            h = h.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, d)
            h = self.attn(h, self.attn_mask, deterministic=deterministic,
                          generator=generator)
            h = h.reshape(b, t // wh, f // ww, wh, ww, d)
            h = h.permute(0, 1, 3, 2, 4, 5).reshape(b, t, f, d)
            if st or sf:
                h = torch.roll(h, shifts=(st, sf), dims=(1, 2))
        x = x + self.norm1(h.reshape(b, l, d))
        return x + self.norm2(self.mlp(x))


class MaskedAutoencoderViT(nn.Module):
    """The MAE (``mae.py:407-610``).  Parameters are created on the CPU,
    initialised from ``generator`` (a fresh one seeded 0 when None) and
    moved to ``device``."""

    def __init__(
        self,
        cfg: MAEConfig,
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.cfg = cfg
        enc_cfg = cfg.encoder_vit_config()
        dec_cfg = cfg.decoder_vit_config()
        d, dd = cfg.embed_dim, cfg.decoder_embed_dim
        p = cfg.num_patches
        dt = _DTYPES[cfg.compute_dtype]

        self.patch_embed = PatchEmbed(enc_cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, p + 1, d),
                                      requires_grad=cfg.pos_trainable)
        self.blocks = nn.ModuleList(Block(enc_cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, 1e-6, dt)

        self.decoder_embed = Linear(d, dd, compute_dtype=dt)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.decoder_pos_embed = nn.Parameter(torch.zeros(1, p + 1, dd),
                                              requires_grad=cfg.pos_trainable)
        if cfg.decoder_mode == 1:
            self.decoder_blocks = nn.ModuleList(
                SwinBlock(dec_cfg, cfg.grid, cfg.window_size,
                          (0, 0) if i % 2 == 0 else (2, 0),
                          cfg.window_attention_impl)
                for i in range(cfg.decoder_depth)
            )
        else:
            self.decoder_blocks = nn.ModuleList(
                Block(dec_cfg) for _ in range(cfg.decoder_depth))
        self.decoder_norm = LayerNorm(dd, 1e-6, dt)
        # the prediction head stays f32: its output feeds the f32 loss
        self.decoder_pred = Linear(dd, cfg.patch_size ** 2,
                                   compute_dtype=torch.float32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Initialise like the JAX model: xavier-uniform for every Linear
        (meta-MLP included) and for the patch conv flattened to
        (O, I*kh*kw), zero biases, unit LayerNorm scales, normal(0.02) CLS
        and mask tokens, logit_scale log 10, and the fixed 2D sin-cos tables
        (zero row for CLS) for both pos embeds."""
        cfg = self.cfg
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                xavier_uniform_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, WindowAttentionV2):
                m.logit_scale.fill_(math.log(10.0))
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.mask_token.normal_(0.0, 0.02, generator=generator)
        for table, dim in ((self.pos_embed, cfg.embed_dim),
                           (self.decoder_pos_embed, cfg.decoder_embed_dim)):
            pos = sincos_2d(dim, cfg.grid, cls_token=True).astype(np.float32)
            table.copy_(torch.from_numpy(pos)[None])

    # -- patch math ------------------------------------------------------

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) -> (B, L, p*p) (``mae.py:467-474``)."""
        p = self.cfg.patch_size
        b, _, hh, ww = imgs.shape
        h, w = hh // p, ww // p
        x = imgs.reshape(b, 1, h, p, w, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(b, h * w, p * p)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        t, f = self.cfg.grid
        b = x.shape[0]
        x = x.reshape(b, t, f, p, p, 1).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, 1, t * p, f * p)

    # -- masking ---------------------------------------------------------

    def masking_noise(self, batch: int, mask_2d: bool,
                      generator: torch.Generator, device=None) -> Noise:
        """Uniform noise for ``random_masking`` ((B, L)) or
        ``random_masking_2d`` (((B, T), (B, F)))."""
        if mask_2d:
            t, f = self.cfg.grid
            return (rand_rows((batch, t), generator, device),
                    rand_rows((batch, f), generator, device))
        return rand_rows((batch, self.cfg.num_patches), generator, device)

    def random_masking(self, x: torch.Tensor, mask_ratio: float,
                       noise: torch.Tensor):
        """(x_masked, mask (B, L) f32 with 1 = masked, ids_restore)."""
        b, l, _ = x.shape
        len_keep = int(l * (1 - mask_ratio))
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        x_masked = take_rows(x, ids_shuffle[:, :len_keep])
        mask = torch.ones((b, l), device=x.device)
        mask[:, :len_keep] = 0
        return x_masked, torch.gather(mask, 1, ids_restore), ids_restore

    def random_masking_2d(self, x: torch.Tensor, mask_t_prob: float,
                          mask_f_prob: float,
                          noise: Tuple[torch.Tensor, torch.Tensor]):
        """The union of masked time rows and frequency columns; kept ids by
        the offset argsort (``mae.py:499-535``)."""
        b, l, _ = x.shape
        t, f = self.cfg.grid
        len_keep_t = int(t * (1 - mask_t_prob))
        len_keep_f = int(f * (1 - mask_f_prob))
        noise_t, noise_f = noise

        def axis_mask(noise_a, size, keep):
            ids_restore = torch.argsort(
                torch.argsort(noise_a, dim=1, stable=True), dim=1, stable=True)
            m = torch.ones((b, size), device=x.device)
            m[:, :keep] = 0
            return torch.gather(m, 1, ids_restore)

        mask_t = axis_mask(noise_t, t, len_keep_t)[:, :, None].expand(b, t, f)
        mask_f = axis_mask(noise_f, f, len_keep_f)[:, None, :].expand(b, t, f)
        mask = (1 - (1 - mask_t) * (1 - mask_f)).reshape(b, l)
        # the reference's literal offset is 999; max(999, t*f) is the same for
        # every reference grid and stays right beyond 999 positions
        offset = float(max(999, t * f))
        id2res = torch.arange(t * f, dtype=torch.float32, device=x.device)
        id2res = id2res[None, :] + offset * mask
        id2res2 = torch.argsort(id2res, dim=1, stable=True)
        x_masked = take_rows(x, id2res2[:, :len_keep_t * len_keep_f])
        ids_restore = torch.argsort(id2res2, dim=1, stable=True)
        return x_masked, mask, ids_restore

    # -- forward ---------------------------------------------------------

    def _pos(self, table: torch.Tensor) -> torch.Tensor:
        return table if self.cfg.pos_trainable else table.detach()

    def forward_encoder(self, imgs: torch.Tensor, mask_ratio: float,
                        noise: Noise, mask_2d: bool = False):
        cfg = self.cfg
        x = self.patch_embed(imgs)
        pos = self._pos(self.pos_embed).to(x.dtype)
        x = x + pos[:, 1:]
        if mask_2d:
            x, mask, ids_restore = self.random_masking_2d(
                x, cfg.mask_t_prob, cfg.mask_f_prob, noise)
        else:
            x, mask, ids_restore = self.random_masking(x, mask_ratio, noise)
        cls = (self.cls_token.to(x.dtype) + pos[:, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x, _ = blk(x, 1.0, False)
        return self.norm(x), mask, ids_restore

    def forward_decoder(self, x: torch.Tensor, ids_restore: torch.Tensor,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None):
        x = self.decoder_embed(x)
        b = x.shape[0]
        n_mask = ids_restore.shape[1] + 1 - x.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(b, n_mask, -1)
        x_ = take_rows(torch.cat([x[:, 1:], mask_tokens], dim=1), ids_restore)
        x = torch.cat([x[:, :1], x_], dim=1)
        x = x + self._pos(self.decoder_pos_embed).to(x.dtype)
        if self.cfg.decoder_mode == 1:
            x = x[:, 1:]  # the swin decoder drops CLS (models_mae.py:370-373)
            for blk in self.decoder_blocks:
                x = blk(x, deterministic, generator)
            return self.decoder_pred(self.decoder_norm(x))
        for blk in self.decoder_blocks:
            x, _ = blk(x, 1.0, False)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]

    def loss(self, imgs: torch.Tensor, pred: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """Masked-patch MSE (``mae.py:587-596``); ``norm_pix_loss``
        normalises each target patch by its mean and unbiased variance."""
        target = self.patchify(imgs)
        if self.cfg.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=1)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        per_patch = ((pred - target) ** 2).mean(dim=-1)
        return (per_patch * mask).sum() / mask.sum().clamp_min(1.0)

    def forward(
        self,
        imgs: torch.Tensor,
        mask_ratio: float = 0.8,
        *,
        mask_2d: Optional[bool] = None,
        noise: Optional[Noise] = None,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True,
    ):
        """(loss, pred (B, L, p*p) f32, mask (B, L)).  ``noise`` is the
        masking noise (``masking_noise``'s shapes); without it the noise is
        drawn from ``generator``, which the decoder's meta-MLP dropout also
        draws from when ``deterministic`` is False."""
        mask_2d = self.cfg.mask_2d if mask_2d is None else mask_2d
        if noise is None:
            noise = self.masking_noise(
                imgs.shape[0], mask_2d,
                _need_generator(generator, "masking"), imgs.device)
        latent, mask, ids_restore = self.forward_encoder(
            imgs, mask_ratio, noise, mask_2d=mask_2d)
        pred = self.forward_decoder(latent, ids_restore, deterministic,
                                    generator)
        return self.loss(imgs, pred, mask), pred, mask
