"""Runtime: flags, fault injection, the supervised step loop, the sharding
rules (``sharding``) and the analytic cell costs (``analytics``).

The submodules are imported by name: ``sharding`` imports the model,
which imports ``flags`` from here.
"""
