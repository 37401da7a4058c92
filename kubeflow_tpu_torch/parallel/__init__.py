"""SPMD parallelism over ``torch.distributed`` device meshes.

Counterpart of ``kubeflow_tpu/parallel/``:

* ``envspec`` — the worker env contract a controller injects;
* ``dist``    — join the process group from that env (or torchrun's);
* ``mesh``    — ``DeviceMesh``es over the axes pp, dp, fsdp, ep, tp, sp;
* ``context`` — the active mesh, for leaf ops;
* ``sharding``— partition rules and the tensor-parallel regions;
* ``train``   — shard a train state and build its sharded step;
* ``ring``, ``ulysses`` — sequence-parallel attention;
* ``pipeline``— GPipe and interleaved pipelines over ``pp``.

Every name is imported on first use, as in the reference, so importing
the package (``models/layers.py`` does) costs nothing.
"""

__all__ = [
    "MeshConfig",
    "make_mesh",
    "default_mesh_config",
    "bert_rules",
    "resnet_rules",
    "t5_rules",
    "vit_rules",
    "batch_sharding",
    "infer_state_shardings",
    "llama_rules",
    "shard_params",
    "make_sharded_train_step",
    "ring_attention",
    "ulysses_attention",
    "pipeline_apply",
]

_LAZY = {
    "MeshConfig": "mesh",
    "make_mesh": "mesh",
    "default_mesh_config": "mesh",
    "batch_sharding": "sharding",
    "bert_rules": "sharding",
    "infer_state_shardings": "sharding",
    "llama_rules": "sharding",
    "resnet_rules": "sharding",
    "shard_params": "sharding",
    "t5_rules": "sharding",
    "vit_rules": "sharding",
    "make_sharded_train_step": "train",
    "ring_attention": "ring",
    "ulysses_attention": "ulysses",
    "pipeline_apply": "pipeline",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(
        importlib.import_module(f"kubeflow_tpu_torch.parallel.{module}"), name)
