"""Operations and bytes of the work a cell asks for, from its shapes alone.

Each count is of what these inputs need, whatever implements it: every
input byte read once and every output byte written once, and the real
edges of the aggregation (the coalesced adjacency the reference derives),
never the padded slots of the port's blocked layout.  Only the products
are counted (GEMMs, the aggregations, the predictor's products): the
element-wise work (activations, dropout, the loss, Adam) is left out, so a
share of the peak built on these counts is never above the true one.

``shape`` is the dict ``refs.gnn.model_shape`` returns: ``num_nodes``,
``num_edges``, ``encoder``, ``layers`` [(fan_in, fan_out), ...],
``predictor``, ``hidden`` (the predictor's width), ``mlp_layers``,
``input_grad_width`` (the columns of the encoder's input that take a
gradient: the trained embedding table's, not the node features').
"""

from __future__ import annotations

# an aggregation's edge list: source and destination as int32, weight as f32
EDGE_BYTES = 12


def aggregation(num_rows: int, num_edges: int, dim: int, elem: int = 4):
    """(flop, bytes) of one weighted aggregation out = A x over ``num_edges``
    real edges: a multiply-add per edge and column; x read once, the edge
    list read once, out written once (K1 is one such launch)."""
    flop = 2 * num_edges * dim
    nbytes = 2 * num_rows * dim * elem + num_edges * EDGE_BYTES
    return flop, nbytes


def _linear(rows: int, fan_in: int, fan_out: int) -> int:
    return 2 * rows * fan_in * fan_out


def encoder_forward_flop(shape) -> int:
    n, e = shape["num_nodes"], shape["num_edges"]
    total = 0
    for fan_in, fan_out in shape["layers"]:
        if shape["encoder"] == "SAGE":  # mean(A x) W_l + x W_r
            total += 2 * e * fan_in + 2 * _linear(n, fan_in, fan_out)
        elif shape["encoder"] == "GCN":  # A (x W)
            total += _linear(n, fan_in, fan_out) + 2 * e * fan_out
        else:
            raise ValueError(f"no count for encoder {shape['encoder']}")
    return total


def encoder_backward_flop(shape) -> int:
    """The weight gradients of every layer, and the input gradients of every
    layer, the first one's over the columns that take a gradient only."""
    n, e = shape["num_nodes"], shape["num_edges"]
    total = 0
    for i, (fan_in, fan_out) in enumerate(shape["layers"]):
        dx = fan_in if i > 0 else shape["input_grad_width"]
        if shape["encoder"] == "SAGE":
            total += 2 * _linear(n, fan_in, fan_out)  # dW_l, dW_r
            total += 2 * _linear(n, dx, fan_out) + 2 * e * dx
        elif shape["encoder"] == "GCN":
            total += _linear(n, fan_in, fan_out) + 2 * e * fan_out  # dW; d(xW) = A^T g
            total += _linear(n, dx, fan_out)
        else:
            raise ValueError(f"no count for encoder {shape['encoder']}")
    return total


def predictor_flop(shape, pairs: int, backward: bool = False) -> int:
    d = shape["hidden"]
    if shape["predictor"] == "DOT":
        fwd = 2 * pairs * d
        return fwd + (2 * fwd if backward else 0)  # d h_i and d h_j
    if shape["predictor"] == "MLP":
        dims = [d] * shape["mlp_layers"] + [1]
        gemm = sum(_linear(pairs, a, b) for a, b in zip(dims[:-1], dims[1:]))
        fwd = pairs * d + gemm  # h_i * h_j, then the linears
        return fwd + ((2 * gemm + 2 * pairs * d) if backward else 0)
    raise ValueError(f"no count for predictor {shape['predictor']}")


def aggregation_dims(shape, backward: bool = False):
    """The column count of each aggregation (each K1 launch) of a forward
    pass, or with ``backward`` of a training step: SAGE aggregates a
    layer's input, GCN its product x W; a backward pass aggregates again
    wherever a gradient flows through A (GCN: every layer, for dW; SAGE:
    the columns of each layer's input that take a gradient)."""
    dims, back = [], []
    for i, (fan_in, fan_out) in enumerate(shape["layers"]):
        if shape["encoder"] == "SAGE":
            dims.append(fan_in)
            dx = fan_in if i > 0 else shape["input_grad_width"]
            if dx:
                back.append(dx)
        elif shape["encoder"] == "GCN":
            dims.append(fan_out)
            back.append(fan_out)
        else:
            raise ValueError(f"no count for encoder {shape['encoder']}")
    return dims + back if backward else dims


def train_step_flop(shape, batch: int, num_neg: int) -> int:
    pairs = batch * (1 + num_neg)
    return (
        encoder_forward_flop(shape)
        + encoder_backward_flop(shape)
        + predictor_flop(shape, pairs, backward=True)
    )


def eval_flop(shape, pairs: int) -> int:
    """One ``Model.test``: the encode and the predictor over ``pairs``."""
    return encoder_forward_flop(shape) + predictor_flop(shape, pairs)


def rank_flop(sources: int, candidates: int, dim: int) -> int:
    """The DOT grid of ``sources`` x ``candidates``."""
    return 2 * sources * candidates * dim
