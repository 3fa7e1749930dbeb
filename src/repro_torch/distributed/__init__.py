"""Sharding over a torch DeviceMesh (counterpart of `repro.distributed`):
the reference's rules, and a train step that keeps the parameters and
optimizer moments sharded by them (`train_step`)."""
from repro_torch.distributed.sharding import (activation_rules, batch_shardings,
                                              fsdp_enabled, param_shardings,
                                              state_shardings)

__all__ = ["param_shardings", "batch_shardings", "state_shardings",
           "fsdp_enabled", "activation_rules"]
