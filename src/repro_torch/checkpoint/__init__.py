"""Checkpointing (port of ``repro/checkpoint``): sharded save/restore in the
JAX package's format, the rolling async manager, elastic restore."""
from repro_torch.checkpoint.ckpt import restore_tree, save_tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.elastic import reshard_restore
