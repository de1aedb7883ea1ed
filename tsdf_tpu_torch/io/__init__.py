"""Host-side I/O: PNG, TUM, PLY and .tsdf files (numpy only)."""
