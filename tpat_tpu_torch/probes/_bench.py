"""The probes' timing loop on the card (counterpart of
``scripts/_bench.py::Bench``).

``bench(name, fn, *args, is_floor=False)`` runs ``fn(*args)`` three times to
warm up, then times ``iters`` calls between two CUDA events, ``REPEATS`` times,
and returns the best ms per call minus the floor; a call with
``is_floor=True`` (a null body) sets the floor and returns it raw.  The raw
best is printed beside each row.

What the JAX harness does and this one does not: it threads a carry into
every call's input (``x + acc * 1e-38``) because XLA hoists a loop-invariant
body out of its ``fori_loop``.  Eager PyTorch launches every call it is
given, so there is nothing to hoist and no carry.  The JAX module's trace
parser (``device_op_durations``) has its counterpart in
``tpat_tpu_torch/cli/profile_forward.py::kernel_rows``, which ranks the device
kernels of a ``torch.profiler`` trace.
"""

from __future__ import annotations

import torch

REPEATS = 3


class Bench:
    """One instance per probe run: holds iters/format state and the floor."""

    def __init__(self, iters: int = 200, name_width: int = 34):
        self.iters = iters
        self.name_width = name_width
        self.floor = 0.0

    def __call__(self, name, fn, *args, is_floor=False) -> float:
        if not torch.cuda.is_available():
            raise RuntimeError("Bench times on a CUDA card; there is none")
        with torch.no_grad():
            for _ in range(3):
                fn(*args)
            best = float("inf")
            for _ in range(REPEATS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(self.iters):
                    fn(*args)
                end.record()
                torch.cuda.synchronize()
                best = min(best, start.elapsed_time(end) / self.iters)
        w = self.name_width
        if is_floor:
            self.floor = best
            print(f"{name:{w}s} {best:7.3f} ms   (floor)", flush=True)
            return best
        print(f"{name:{w}s} {best - self.floor:7.3f} ms   (raw {best:7.3f})",
              flush=True)
        return best - self.floor
