"""Host-side data path of the port: NIfTI I/O, preprocessing, the manifest."""
