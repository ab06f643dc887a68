"""Core of the port: specs, layouts, the strategy registry, the engine,
CacheHash and the v1 shims."""
