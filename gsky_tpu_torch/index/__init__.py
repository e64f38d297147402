"""index: the metadata index (MAS), its crawler and client."""
