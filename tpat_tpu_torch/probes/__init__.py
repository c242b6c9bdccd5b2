"""Kernel probes of the port, the counterparts of the Pallas probes in
``scripts/`` (``python -m tpat_tpu_torch.probes.<name>`` on the card):
``probe_attn_softmax`` (P1), ``probe_attn_grouping`` (P2) and
``probe_ln_matmul`` (P3), timed by ``_bench.Bench``."""
