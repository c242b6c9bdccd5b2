"""Decoding patch importance: the analysis of extracted features
(``python -m tpat_tpu_torch.analysis.extract_stats``) and the reducers of
experiment results (``python -m tpat_tpu_torch.analysis.reducers``)."""
