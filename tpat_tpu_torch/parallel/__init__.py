"""Data parallelism across processes (``tpat_tpu/parallel``): the process
group and its collectives (``distributed``) and the rows of a global batch
that each process holds (``mesh``).  Tensor parallelism (the JAX package's
``sharding.py`` and ``--model_axis``) is not ported: ROADMAP A11b."""
