"""FLOP and byte counts, one module per model family, found by the
``family`` of a configuration file.  Frozen: a later change to the program
does not change what its work is counted as."""
