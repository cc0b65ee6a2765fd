"""Training state under a mesh (port of plnlp_tpu/parallel/sharded.py).

The embedding table and its Adam moments are row-sharded like the table
(a rank holds its slot rows, ``Model.place_rows``); everything else is
replicated.  This module moves that state between its per-rank layout and
the whole table in original node order, the layout a checkpoint keeps (as
orbax writes the JAX package's global arrays), so a checkpoint written at
one shard count resumes at another.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["full_state", "load_full_state", "reduce_gradients"]


def _emb_index(model, opt) -> int:
    """Position of the embedding table among the optimizer's parameters."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return next(i for i, p in enumerate(params) if p is model.emb)


@torch.no_grad()
def full_state(model, opt=None) -> Tuple[Dict, Dict]:
    """(model state_dict, optimizer state_dict) with the embedding table and
    its moments whole, in original node order.  Collective over the node
    group when the table is sharded; every rank gets the same state."""
    gp = model.row_placement
    state = model.state_dict()
    opt_state = None if opt is None else opt.state_dict()
    if gp is None or model.emb is None:
        return state, opt_state
    from plnlp_tpu_torch.parallel.graph_parallel import gather_node_features

    state = dict(state, emb=gather_node_features(model.emb.detach(), gp).cpu())
    if opt_state is not None and model.emb.requires_grad:
        k = _emb_index(model, opt)
        moments = opt_state["state"].get(k)
        if moments is not None:
            opt_state["state"][k] = {
                name: gather_node_features(v, gp).cpu()
                if torch.is_tensor(v) and v.shape == model.emb.shape else v
                for name, v in moments.items()
            }
    return state, opt_state


@torch.no_grad()
def load_full_state(model, opt, state: Dict, opt_state: Dict = None) -> None:
    """Load a whole-table state (``full_state``'s, or a single-device
    checkpoint's) into a model whose table may be sharded: every rank takes
    its rows."""
    gp = model.row_placement
    if gp is not None and model.emb is not None:
        from plnlp_tpu_torch.parallel.graph_parallel import shard_node_features

        emb = state["emb"].to(gp.device)
        state = dict(state, emb=shard_node_features(emb, gp))
        if opt_state is not None and model.emb.requires_grad:
            k = _emb_index(model, opt)
            moments = opt_state["state"].get(k)
            if moments is not None:
                opt_state = dict(opt_state, state=dict(opt_state["state"]))
                opt_state["state"][k] = {
                    name: shard_node_features(v.to(gp.device), gp)
                    if torch.is_tensor(v) and v.shape == emb.shape else v
                    for name, v in moments.items()
                }
    model.load_state_dict(state)
    if opt is not None and opt_state is not None:
        opt.load_state_dict(opt_state)


def reduce_gradients(model, mesh) -> None:
    """Sum every gradient over the ranks that hold the parameter: the
    replicated ones over the world, in one flat all_reduce; a row-sharded
    table's over the data group (the ranks holding the same rows).  With
    every rank's loss a distinct share of the global loss, each sum is the
    single-device gradient."""
    import torch.distributed as dist

    if mesh.world_size == 1:
        return
    sharded = model.emb if model.row_placement is not None else None
    grads = [p.grad for p in model.parameters() if p.grad is not None and p is not sharded]
    if grads:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
    if sharded is not None and sharded.grad is not None and mesh.data_group is not None:
        dist.all_reduce(sharded.grad, group=mesh.data_group)

