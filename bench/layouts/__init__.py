"""The leaves of each block kind, one module per model family, found by the
``family`` of a configuration file.

A module gives ``block(m, kind)``: the ``(shape, std, dtype name)`` of
every leaf of one block of ``kind`` (one layer, without the stacked axis),
as a nested dict in drawing order; ``{}`` for a kind that invokes the
model's one shared block, whose leaves are ``block(m, SHARED)``.  A module
whose family has no shared block leaves ``SHARED`` out.  ``bench.weights``
lays the blocks out as the program's parameter tree."""
