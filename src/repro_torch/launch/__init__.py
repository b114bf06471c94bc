"""Device handle, step factories and the one-shot serving entry point."""
