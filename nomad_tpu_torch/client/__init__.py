"""Client agent (reference ``client/``): node runtime executing allocations.

The PyTorch port has only ``devicemanager`` of this package so far. The
reference's ``__init__`` imports the whole runtime
(``nomad_tpu/client/__init__.py``); the port's exports nothing eagerly
until the client is ported.
"""
