"""Host utilities: profiling (FLOPs, MFU, traces) and energy tracking."""
