"""Model code of the port (the cached/paged GPT steps)."""
