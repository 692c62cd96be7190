"""Entry points: the serving CLI and the engine profile."""
