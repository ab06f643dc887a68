"""Core of the port: specs, layouts, the strategy registry and the engine."""
