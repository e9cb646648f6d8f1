"""Device resolution, 32-bit lane helpers and stage timing."""
