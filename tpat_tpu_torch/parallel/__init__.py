"""Parallelism across processes (``tpat_tpu/parallel``), one process per
device: the process group and its collectives (``distributed``), the rows
of a global batch that each process holds (``mesh``), and tensor
parallelism over a (data, model) split of the ranks with Megatron's
column- and row-parallel blocks (``sharding``, ``--model_axis``)."""
