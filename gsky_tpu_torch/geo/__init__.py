"""geo: CRS, geotransforms and polygon geometry (host, numpy)."""
