"""Host data path (port of ``grafp_tpu.data``): audio decoding,
resampling, the dataset index, the pair batcher and the track loader."""
