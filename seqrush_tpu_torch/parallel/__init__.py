"""Multi-device and multi-process alignment: batch sharding over a mesh of
devices (``mesh``), one pair's band sharded by lanes (``bandshard``), and
pair striping over processes joined by torch.distributed (``distributed``).
The port of ``seqrush_tpu/parallel/``."""
