"""The parallel tier, port of ``flamingo_mini_tpu/parallel/``.

JAX expresses parallelism as one program over a named device mesh, with
GSPMD inserting the collectives. The port runs one process per rank over
``torch.distributed`` (``nccl`` on cards, ``gloo`` on the CPU or where
ranks share a card), with the collectives written out:

* ``mesh``: ``distributed_init`` (the ``tcp://`` rendezvous) and
  ``create_mesh`` (a named ``DeviceMesh``, ``("data", "model")``);
* ``comm``: the few collectives, and the Megatron autograd functions;
* ``sharding``: JAX's Megatron rule over the parameter tree, a rank's
  slices (``shard_params``), the vocab padding;
* ``ring_attention``: causal attention with the sequence split over a
  group (``FlamingoModel.forward(context_mesh=...)``).

Data-parallel and tensor-parallel serving are ``FlamingoModel.generate(
mesh=..., tensor_parallel=...)``; training, ``TrainingArguments(mesh_shape=
..., tensor_parallel=...)``.
"""
from .mesh import axis_size, create_mesh, distributed_init
from .sharding import (AxisNames, check_tensor_parallel, pad_vocab_params,
                       shard_batch, shard_params)

__all__ = [
    "create_mesh", "distributed_init", "axis_size", "AxisNames",
    "check_tensor_parallel", "pad_vocab_params", "shard_batch", "shard_params",
]
