"""HTTP agent (reference ``command/agent``).

The PyTorch port has only ``jsonapi`` of this package so far: the
struct <-> JSON mapping that ``structs.diff`` names its fields with. The
reference's ``__init__`` imports ``Agent`` (``nomad_tpu/agent/__init__.py``),
which pulls in the client and gossip; the port's exports nothing eagerly
until those are ported.
"""
