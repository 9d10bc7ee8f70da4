"""Host-side helpers: metrics and step timing."""
