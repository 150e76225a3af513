"""External system integrations: Vault (secrets) and Consul (service
registry), talked to over their HTTP APIs with in-tree mock servers for
tests (reference nomad/vault.go, command/agent/consul/).

Copied from ``nomad_tpu/integrations/__init__.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``.
"""
