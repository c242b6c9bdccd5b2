"""Serving traffic: the port's bucketed eval forward
(``utils/serving.py``: ``export_forward`` then ``load_forward``), one
client sending eval folds of clips that sit on the device, open loop.

The traffic file gives the fold's clip count, its requests (sizes taken in
turn over the fold's clips), the rate at which requests fall due (an open
loop: each request is due its clip count over the rate after the one
before, whether or not that one has its answer), the artifact's buckets,
and the limits.
Set-up exports an artifact of the seeded weights under ``TMPDIR``, loads it
(the artifact is then deleted), makes the fold's clips and sends the fold
once, which warms the buckets the requests take.  In the window each
request's logits are read back to the host before the next is sent; its
latency runs from the time it fell due to the logits on the host, so a
request that waits behind a slow one counts the wait.  Every answer is
kept and compared once the window has closed.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import Window
from benchmark.lib import compare, seeds, work
from benchmark.lib.program import check_sizes, no_tf32, tuples
from benchmark.lib.trace import percentile
from benchmark.reference import precision
from benchmark.reference import vit as ref_vit


def clips(config: Dict, traffic: Dict, seed: int, device) -> torch.Tensor:
    m = config["model"]
    gen = seeds.generator(seed, "data", device)
    return torch.randn(traffic["clips"], 1, m["target_length"],
                       m["num_mel_bins"], device=device, generator=gen)


def requests(traffic: Dict) -> List[tuple]:
    """(first clip, clip count) of each request of a fold."""
    out, at = [], 0
    for n in traffic["requests"]:
        out.append((at, n))
        at += n
    if at != traffic["clips"]:
        raise ValueError(f"the requests cover {at} clips, the fold has "
                         f"{traffic['clips']}")
    return out


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.fold = requests(traffic)
        self.buckets = sorted(traffic["buckets"])

    def _send(self, start: int, n: int):
        """(logits on the host, seconds until the call returned)."""
        t0 = time.perf_counter()
        out = self.fn(self.x[start:start + n])
        enq = time.perf_counter() - t0
        return out.cpu().numpy(), enq

    def setup(self):
        from tpat_tpu_torch import config as pc
        from tpat_tpu_torch.models.vit import AudioViT
        from tpat_tpu_torch.utils.serving import export_forward, load_forward

        c = self.config
        m = c["model"]
        prog = c["program"]
        cfg = getattr(pc, prog["factory"])(**tuples(prog["args"]))
        check_sizes(cfg, m)
        w0 = seeds.weights(ref_vit.param_specs(m), self.seed, self.device)
        model = AudioViT(cfg, device=self.device)
        model.load_state_dict(w0, strict=True)
        del w0
        out_dir = tempfile.mkdtemp(prefix="tpat_bench_serve_",
                                   dir=os.environ.get("TMPDIR"))
        try:
            export_forward(model, (1, 1, m["target_length"], m["num_mel_bins"]),
                           out_dir, batch_sizes=self.buckets)
            del model
            self.fn, _ = load_forward(out_dir, device=str(self.device))
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        self.x = clips(c, self.traffic, self.seed, self.device)
        for start, n in self.fold:
            self._send(start, n)

    def run(self, seconds: float) -> Window:
        """Requests fall due at the traffic's fixed rate, each ``n / rate``
        seconds after the one before (rate 0: each when the one before has
        its answer, a closed loop); the window sends whole folds of those
        due in its first ``seconds`` until ``seconds`` have passed (above
        capacity the backlog is never sent) and ends with the last
        answer."""
        from torch.profiler import record_function

        rate = self.traffic["rate_clips_per_s"]
        static = work.static_step(self.config["model"])
        enq, lat, units, self.answers = [], [], [], []
        service = 0.0
        t0 = time.perf_counter()
        due = t0
        while due - t0 < seconds and time.perf_counter() - t0 < seconds:
            for start, n in self.fold:
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                ts = time.perf_counter()
                with record_function("bench.request"):
                    logits, e = self._send(start, n)
                done = time.perf_counter()
                service += done - ts
                lat.append(done - (due if rate else ts))
                enq.append(e)
                self.answers.append((start, logits))
                units.append({"model": "vit", "step": static, "rows": n,
                             "batch": next(b for b in self.buckets if b >= n),
                             "backward": False})
                due = due + n / rate if rate else done
        t1 = time.perf_counter()
        return Window(t1 - t0, len(units), sum(u["rows"] for u in units), enq,
                      units, lat, service)

    def end_to_end(self, window: Window) -> Dict:
        return {"serve_p95_ms": percentile(window.latency_s, 95) * 1e3,
                "serve_clips_per_s": window.clips / window.seconds}

    def free(self):
        del self.fn, self.x

    def reference(self, prec) -> np.ndarray:
        """The reference's logits of every clip of the fold."""
        c, t = self.config, self.traffic
        m = c["model"]
        step = work.static_step(m)
        with no_tf32(), torch.no_grad():
            P = seeds.weights(ref_vit.param_specs(m), self.seed, self.device)
            x = clips(c, t, self.seed, self.device)
            out = []
            for s in range(0, x.shape[0], t["reference_rows"]):
                rows = x[s:s + t["reference_rows"]]
                draw = ref_vit.draws(m, step, rows.shape[0], None, self.device,
                                     train=False)
                out.append(ref_vit.forward(P, m, step, rows, draw, prec).cpu())
        return torch.cat(out).numpy()

    def check(self, prec=precision.F32) -> Dict:
        ref = self.reference(prec)
        got = np.concatenate([a for _, a in self.answers])
        want = np.concatenate([ref[s:s + a.shape[0]] for s, a in self.answers])
        return compare.serve_numbers(got, want)
