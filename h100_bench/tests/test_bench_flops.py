"""The FLOP and byte counts against counts made by hand on tiny graphs."""

from h100_bench import flops, peaks


def test_aggregation_counts_each_byte_once():
    # 3 rows, 4 edges, 2 columns: 4 edges x 2 columns multiply-adds;
    # x read (3 x 2 x 4 B), out written (3 x 2 x 4 B), 4 edges of 12 B
    assert flops.aggregation(3, 4, 2) == (16, 24 + 24 + 48)


def test_sage_dot_step_by_hand():
    shape = {"num_nodes": 3, "num_edges": 4, "encoder": "SAGE", "layers": [(2, 2), (2, 2)],
             "predictor": "DOT", "hidden": 2, "mlp_layers": 2, "input_grad_width": 2}
    # a layer forward: aggregation 2*4*2 = 16, two linears 2*(2*3*2*2) = 48
    assert flops.encoder_forward_flop(shape) == 2 * (16 + 48)
    # a layer backward: dW_l, dW_r 48, dx through both linears 48, A^T 16
    assert flops.encoder_backward_flop(shape) == 2 * (48 + 48 + 16)
    # 2 positives, 1 negative each: 4 pairs, 2*4*2 = 16 forward, 32 backward
    assert flops.train_step_flop(shape, 2, 1) == 128 + 224 + 48
    assert flops.aggregation_dims(shape, backward=True) == [2, 2, 2, 2]
    # one of layer 0's two input columns trained: dx 2*(2*3*1*2) + A^T 2*4*1
    shape["input_grad_width"] = 1
    assert flops.encoder_backward_flop(shape) == (48 + 24 + 8) + (48 + 48 + 16)
    assert flops.aggregation_dims(shape, backward=True) == [2, 2, 1, 2]


def test_gcn_mlp_step_by_hand():
    shape = {"num_nodes": 3, "num_edges": 5, "encoder": "GCN", "layers": [(4, 2), (2, 2)],
             "predictor": "MLP", "hidden": 2, "mlp_layers": 2, "input_grad_width": 0}
    # forward: 2*3*4*2 + 2*5*2 = 48 + 20; 2*3*2*2 + 20 = 24 + 20
    assert flops.encoder_forward_flop(shape) == 68 + 44
    # backward: layer 0 dW 48 + A^T 20 (no dx); layer 1 dW 24 + A^T 20 + dx 24
    assert flops.encoder_backward_flop(shape) == 68 + 68
    # 1 pair: h_i*h_j 2, linears 2*2*2 + 2*2*1 = 12; backward 2*12 + 2*2
    assert flops.predictor_flop(shape, 1) == 14
    assert flops.predictor_flop(shape, 1, backward=True) == 14 + 28
    assert flops.aggregation_dims(shape) == [2, 2]
    assert flops.aggregation_dims(shape, backward=True) == [2, 2, 2, 2]
    assert flops.eval_flop(shape, 1) == 112 + 14
    # one of layer 0's four input columns trained (a table beside three
    # features): its input gradient 2*3*1*2 = 12, over that column only
    shape["input_grad_width"] = 1
    assert flops.encoder_backward_flop(shape) == (68 + 12) + 68
    assert flops.aggregation_dims(shape, backward=True) == [2, 2, 2, 2]
    assert flops.rank_flop(2, 3, 4) == 48


def test_bound_takes_the_slower_of_flop_and_bytes():
    assert peaks.bound_s(67e12, 0) == 1.0
    assert peaks.bound_s(0, 3.35e12) == 1.0
    assert peaks.bound_s(989e12, 0, "bfloat16") == 1.0
