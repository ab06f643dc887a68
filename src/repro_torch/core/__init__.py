"""Core of the port: specs, layouts, the strategy registry, the engine,
CacheHash, the versioned store, the wait-free writable cell and the v1
shims."""
