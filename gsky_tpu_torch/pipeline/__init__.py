"""pipeline: scene cache, page pool, executor and tile pipeline."""
