"""Host-side helpers: encodings and metrics."""
