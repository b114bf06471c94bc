"""Plain float32 references, one module per model family, found by the
``family`` of a configuration file."""
