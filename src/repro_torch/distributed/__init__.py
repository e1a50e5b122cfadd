"""Multi-device training over ``torch.distributed`` (port of
:mod:`repro.distributed`): the sharding rule tables resolved to
``DeviceMesh`` placements (:mod:`.sharding`), the explicit allreduce
schedules (:mod:`.allreduce`) and the GPipe schedule (:mod:`.pipeline`).

The ``spmd`` cluster mode (:mod:`repro_torch.launch.cluster`) trains one
replica a rank and sums gradients with these collectives: NCCL between
cards, ``gloo`` between CPU processes (or ranks that share a card).  Under
a plan that shards weights over ``data`` it is ZeRO-3 (:mod:`.zero`): a rank
keeps its slice of every such leaf and gathers one layer's weights at a
time.  On a mesh with a ``model`` axis (``launch.mesh.make_host_mesh``)
every family's training forward is tensor-parallel, the MoE layer
expert-parallel (:mod:`.tensor`).
"""
from repro_torch.distributed.sharding import (
    SHARDED_WEIGHTS, Layout, ProcessMesh, ShardingPlan, arg_shardings_for_tree,
    check_plan, get_mesh, get_rules, is_zero3, make_rules, mesh_axis_sizes, placements_for,
    reset_constraint_warnings, set_rules, spec_for, specs_for_tree, use_mesh, use_rules,
    with_logical_constraint,
)

__all__ = [
    "SHARDED_WEIGHTS",
    "Layout",
    "ProcessMesh",
    "ShardingPlan",
    "arg_shardings_for_tree",
    "check_plan",
    "get_mesh",
    "get_rules",
    "is_zero3",
    "make_rules",
    "mesh_axis_sizes",
    "placements_for",
    "reset_constraint_warnings",
    "set_rules",
    "spec_for",
    "specs_for_tree",
    "use_mesh",
    "use_rules",
    "with_logical_constraint",
]
