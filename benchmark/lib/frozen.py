"""Frozen copies of the port's work counts, trace readers and traffic.

Copied from commit 80e6d88 so that the yardstick stays put while the
program changes:

- ``chip_smoke.py``: ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``exp_rate`` (the
  SM clock passed in, where the original reads a global), ``bound_ms``,
  ``work_bound``, ``qkv_work`` and ``window_work`` (split into
  ``window_work_shapes``, which takes the template's size and live pairs,
  and the original, which counts them from a tensor);
- ``tpat_tpu_torch/cli/profile_forward.py``: ``card_name``;
- ``tpat_tpu_torch/cli/profile_train.py``: ``synthetic_batches`` (the shape
  given, where the original takes a config).  Its ``train_configs`` is
  carried by ``benchmark/configs/audiomae-vitb16-esc50.json`` as data.
"""

from __future__ import annotations

import subprocess

# the H100 SXM's published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the special-function unit's exp rate (CUDA C++ Programming Guide, the
# arithmetic-instruction throughput table, compute capability 9.0): 16 a
# clock per SM, on the H100 SXM's 132 SMs, at the card's maximum SM clock
EXPS_PER_SM_CLOCK = 16
H100_SMS = 132


def exp_rate(sm_clock_hz: float) -> float:
    """Exps per second the card's special-function units can take."""
    return EXPS_PER_SM_CLOCK * H100_SMS * sm_clock_hz


def bound_ms(nbytes: float, flops: float, dtype: str, exps: float = 0.0,
             sm_clock_hz: float = 0.0) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the H100 could take to
    move ``nbytes`` (each input read once, each output written once), do
    ``flops`` on ``dtype`` inputs and take ``exps`` exponentials, the
    largest of the three at the published peaks and ``exp_rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if exps:
        if not sm_clock_hz:
            raise ValueError("an exp bound needs the card's SM clock")
        t_ops = max(t_ops, exps / exp_rate(sm_clock_hz) * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_bound(work: tuple, dtype: str, sm_clock_hz: float) -> tuple:
    """``bound_ms`` of a (bytes, FLOPs, exps) tuple (``qkv_work``,
    ``window_work``)."""
    nbytes, flops, exps = work
    return bound_ms(nbytes, flops, dtype, exps, sm_clock_hz)


def qkv_work(b, n, c3, h, itemsize, mode=None, extra=1, kv=None,
             bwd=False) -> tuple:
    """(bytes, FLOPs, exps) a B1/B2 forward or B3 backward needs: q's N rows
    and k, v's first kv_valid rows (keys past it need neither reading nor
    work), the output, the scores (f32) where a mode asks for them; the
    backward reads dO too and writes the packed gradient.  FLOPs: 4 N kv D
    per (sample, head) forward, 10 N kv D backward (q.k^T, dO.v^T, dq, dk,
    dv).  Exps: one per (query, valid key) pair, B H N kv, forward and
    backward alike (the backward needs p again)."""
    c = c3 // 3
    kv = n if kv is None else kv
    read = n * c + 2 * kv * c
    exps = b * h * n * kv
    if bwd:
        return (itemsize * b * (read + n * c + n * c3),
                10 * b * h * n * kv * (c // h), exps)
    scores = 4 * b * (n - extra) if mode is not None else 0
    return (itemsize * b * (read + n * c) + scores,
            4 * b * h * n * kv * (c // h), exps)


def window_work_shapes(b, n, c3, h, itemsize, template_numel, pairs,
                       bwd: bool) -> tuple:
    """``window_work`` from sizes: the template's element count and its
    live pairs (entries that are not the -1e30 exclusion)."""
    c = c3 // 3
    io = itemsize * b * n
    tmpl = template_numel * 4 + 4 * h
    if bwd:
        return (io * (c3 + c + c3) + 2 * tmpl, 10 * b * pairs * (c // h),
                b * pairs)
    return io * (c3 + c) + tmpl, 4 * b * pairs * (c // h), b * pairs


def window_work(qkv, template, banded: bool, bwd: bool) -> tuple:
    """(bytes, FLOPs, exps) a window-attention forward or backward needs on
    these inputs: qkv, the template (f32) and the (H,) scales read, the
    output written; the backward reads dO too and writes d_qkv, d_template
    and d_scale.  FLOPs and exps count only the pairs whose template entry
    is not the -1e30 exclusion (the other probabilities are exact zeros): 4
    D FLOPs per pair forward, 10 D backward, one exp per pair in both."""
    b, n, c3 = qkv.shape
    h = template.shape[0]
    pairs = int((template > -1e29).sum().item())
    return window_work_shapes(b, n, c3, h, qkv.element_size(),
                              template.numel(), pairs, bwd)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock_max_hz() -> float:
    """The card's maximum SM clock in Hz, as nvidia-smi reports it (the
    clock ``chip_smoke.py::check_device`` reads for the exp bound)."""
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(clock.split()[0]) * 1e6


# --- profile_train.py ------------------------------------------------------


def synthetic_batches(torch, shape, num_classes: int, n: int, generator,
                      device):
    """``n`` seeded (spectrogram, one-hot label) batches on ``device`` from
    ``generator`` (``profile_train.synthetic_batches``, the shape given)."""
    out = []
    for _ in range(n):
        x = torch.randn(*shape, device=device, generator=generator)
        labels = torch.randint(0, num_classes, (shape[0],), device=device,
                               generator=generator)
        out.append((x, torch.nn.functional.one_hot(labels, num_classes)
                    .float()))
    return out
