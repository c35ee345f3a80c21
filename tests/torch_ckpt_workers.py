"""What the port's ranks run in the checkpoint and reshard tests:
functions ``paddle_tpu_torch.distributed.spawn`` calls in fresh
processes (torch, numpy and the port only; never JAX)."""
import torch

from paddle_tpu_torch.distributed import reshard
from paddle_tpu_torch.distributed.fault_tolerance import CheckpointManager
from paddle_tpu_torch.distributed.plan import Plan
from paddle_tpu_torch.models import llama as tllama


def _cfg(fields):
    return tllama.LlamaConfig(dtype=torch.float32, fused_blocks="off",
                              **fields)


def _np(tree):
    return {p: (v.detach().numpy().copy() if torch.is_tensor(v) else v)
            for p, v in reshard._flat(tree)}


def save_world(fields, np_params, batches, plan_kw, root):
    """Train ``len(batches)`` steps on ``plan_kw``'s topology from
    ``np_params``, gather the whole train state (collective) and save
    it from rank 0; every rank returns the gathered state by path."""
    torch.set_num_threads(1)
    cfg = _cfg(fields)
    step, init = Plan(**plan_kw).train_step(cfg, device="cpu")
    params, opt = init(params=tllama.shard_params(
        cfg, np_params, step.plan_topology, device="cpu"))
    for b in batches:
        step(params, opt, step.shard_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}))
    full = reshard.gather_train_state(params, opt)
    if step.plan_topology.rank == 0:
        CheckpointManager(root, specs=tllama.param_specs(cfg)).save(
            len(batches), full, sync=True)
    torch.distributed.barrier()
    return _np(full)


def restore_world(fields, plan_kw, root):
    """``reshard.restore_resharded`` onto ``plan_kw``'s topology, then
    the train step's params and ZeRO state from it; returns this rank's
    coordinates, its parameter shards, its moments gathered over the
    zero axis (collective), its own ZeRO blocks, and what
    ``local_train_state`` says (a ``ValueError`` on a leaf a peer
    partly holds)."""
    torch.set_num_threads(1)
    cfg = _cfg(fields)
    step, init = Plan(**plan_kw).train_step(cfg, device="cpu")
    topo = step.plan_topology
    state, got = reshard.restore_resharded(root, topo=topo, device="cpu")
    params, opt = init(params=state["params"])
    opt.load_state_tree(state["opt_state"])
    try:
        local = _np(reshard.local_train_state(params, opt))
        raised = None
    except ValueError as e:
        local, raised = None, str(e)
    return {"step": got, "coords": dict(topo.coords), "dims": topo.dims,
            "params": _np(params), "moments": _np(opt.full_state_tree()),
            "blocks": _np(opt.state_tree()), "zero": {
                p: d for p, _, d, _ in opt.leaves},
            "zero_axis": opt.axis, "local": local, "raised": raised}
