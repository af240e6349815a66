"""Data and tensor parallelism over several cards: the counterpart of
`fcd_tpu/parallel/` (`mesh.py`, `dp.py`, `sw.py`, `tp.py`) on
torch.distributed, one process per card."""
