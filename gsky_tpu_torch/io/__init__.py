"""io: raster codecs."""
