"""The networks that configurations name (``network``), one file each."""
