"""Native host code of the port: the data loader's fused resize, crop and
normalization (imgops.c, built at first use by build.py)."""
