"""The host data pipeline of the port (``tpat_tpu/data``): WAV decoding,
the Kaldi fbank, augmentations, samplers, datasets and the threaded
loader.  Batches are numpy; the engine moves them to the device."""
