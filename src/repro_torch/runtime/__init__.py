"""Runtime: flags, fault injection and the supervised step loop.

The reference's sharding rules (``repro/runtime/sharding.py``) are not
ported: the port runs on one card (ROADMAP A12).
"""
