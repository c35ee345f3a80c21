"""The port's RNN, transformer and decode layers on the CPU against the
JAX package.

The layers whose outputs are a flat tuple run through
``torch_nn_cases.SEQ`` (``check_layer``: the JAX layer's weights into
the port's by ``set_state_dict`` of numpy arrays, the same seeded input,
outputs at 1e-4 and the gradients of ``Σ out * w`` w.r.t. the inputs and
every parameter at 1e-4, f32).  Here, at the same tolerances: LSTM's
nested states in every direction and ``time_major``, the ``RNN`` /
``BiRNN`` wrappers over given cells, multi-layer stacks with initial
states, ``MultiHeadAttention`` with both caches and ``need_weights``,
the encoder and decoder stacks with their caches, and
``dynamic_decode``'s ids and lengths (exact), with beams that finish
early and tied candidates, where the lower index must win as in
``jax.lax.top_k``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_nn_cases import SEQ, check_layer, compare_runs, pair_run


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


@pytest.mark.parametrize("cls,args,kwargs,inputs,eval_,tol", SEQ)
def test_layer_matches_the_reference(cls, args, kwargs, inputs, eval_, tol):
    check_layer(cls, args, kwargs, inputs, eval_, tol)


def _n(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("direction,time_major",
                         [("forward", False), ("backward", False),
                          ("bidirect", True), ("bidirectional", False)])
def test_lstm_every_direction(direction, time_major):
    rng = np.random.default_rng(0)
    B, T, nd = 2, 3, 2 if direction.startswith("bidirect") else 1
    x = _n(rng, T, B, 4) if time_major else _n(rng, B, T, 4)
    h0, c0 = _n(rng, 2 * nd, B, 4), _n(rng, 2 * nd, B, 4)

    def build(P):
        return P.nn.LSTM(4, 4, num_layers=2, direction=direction,
                         time_major=time_major)

    if nd == 1:
        compare_runs(pair_run(build, [x], lambda P, lay, xs: lay(xs[0])))
    else:
        compare_runs(pair_run(build, [x, h0, c0],
                              lambda P, lay, xs: lay(xs[0],
                                                     (xs[1], xs[2]))))


def test_lstm_cell_and_the_wrappers():
    rng = np.random.default_rng(1)
    x, h, c = _n(rng, 2, 4), _n(rng, 2, 4), _n(rng, 2, 4)
    seq = _n(rng, 2, 3, 4)
    compare_runs(pair_run(lambda P: P.nn.LSTMCell(4, 4), [x, h, c],
                          lambda P, lay, xs: lay(xs[0], (xs[1], xs[2]))))
    compare_runs(pair_run(
        lambda P: P.nn.RNN(P.nn.GRUCell(4, 4), is_reverse=True),
        [seq], lambda P, lay, xs: lay(xs[0])))
    compare_runs(pair_run(
        lambda P: P.nn.BiRNN(P.nn.LSTMCell(4, 4), P.nn.LSTMCell(4, 4)),
        [seq], lambda P, lay, xs: lay(xs[0])))
    compare_runs(pair_run(
        lambda P: P.nn.RNN(P.nn.SimpleRNNCell(4, 4), time_major=True),
        [np.swapaxes(seq, 0, 1).copy(), h],
        lambda P, lay, xs: lay(xs[0], xs[1])))
    # the initial states a cell makes: zeros of [batch] + state_shape
    cell = tpaddle.nn.LSTMCell(4, 4)
    h0, c0 = cell.get_initial_states(tpaddle.to_tensor(seq),
                                     batch_dim_idx=0)
    assert h0.shape == [2, 4] and c0.shape == [2, 4]
    assert not np.any(h0.numpy())


def test_rnn_inter_layer_dropout_follows_train_and_eval():
    rng = np.random.default_rng(2)
    x = _n(rng, 2, 3, 4)
    compare_runs(pair_run(
        lambda P: P.nn.GRU(4, 4, num_layers=3, dropout=0.5).eval(),
        [x], lambda P, lay, xs: lay(xs[0])))
    tpaddle.seed(0)
    lay = tpaddle.nn.LSTM(4, 4, num_layers=2, dropout=0.5)
    a = lay(tpaddle.to_tensor(x))[0].numpy()
    b = lay(tpaddle.to_tensor(x))[0].numpy()
    assert not np.allclose(a, b)        # a fresh mask a call in training
    lay.eval()
    np.testing.assert_array_equal(lay(tpaddle.to_tensor(x))[0].numpy(),
                                  lay(tpaddle.to_tensor(x))[0].numpy())


def test_multi_head_attention_caches_and_need_weights():
    rng = np.random.default_rng(3)
    q, mem = _n(rng, 2, 4, 8), _n(rng, 2, 5, 8)
    steps = [_n(rng, 2, 1, 8) for _ in range(2)]

    def incremental(P, lay, xs):
        cache = lay.gen_cache(xs[0])
        outs = []
        for x in xs[1:]:
            out, cache = lay(x, x, x, None, cache)
            outs.append(out)
        return outs + [cache.k, cache.v]

    def static(P, lay, xs):
        # need_weights: the reference's weight slot is None
        cache = lay.gen_cache(xs[1], xs[1], type(lay).StaticCache)
        out = lay(xs[0], None, None, None, cache)
        assert isinstance(out, tuple) and out[1] is None
        return out[0], cache.k

    compare_runs(pair_run(lambda P: P.nn.MultiHeadAttention(8, 2),
                          [q] + steps, incremental))
    compare_runs(pair_run(
        lambda P: P.nn.MultiHeadAttention(8, 2, need_weights=True),
        [q, mem], static))


def _enc_dec(P, normalize_before):
    nn = P.nn
    enc = nn.TransformerEncoder(
        nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                   normalize_before=normalize_before),
        1, nn.LayerNorm(8) if normalize_before else None)
    dec = nn.TransformerDecoder(
        nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0,
                                   normalize_before=normalize_before),
        2, nn.LayerNorm(8) if normalize_before else None)
    return nn.LayerList([enc, dec])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_decoder_stacks_with_caches(normalize_before):
    rng = np.random.default_rng(4)
    src, tgt = _n(rng, 2, 5, 8), _n(rng, 2, 4, 8)

    def run(P, lay, xs):
        enc, dec = lay[0], lay[1]
        mask = P.to_tensor(np.triu(np.full((4, 4), -1e9, np.float32), 1))
        memory = enc(xs[0])
        full = dec(xs[1], memory, mask)
        enc_out, enc_cache = enc(xs[0], None, enc.gen_cache(xs[0]))
        cache = dec.gen_cache(memory)
        outs = []
        for t in range(2):
            step = P.slice(xs[1], [1], [t], [t + 1])
            o, cache = dec(step, memory, None, None, cache)
            outs.append(o)
        return [full, enc_out, memory] + outs + [enc_cache[0].k]

    compare_runs(pair_run(lambda P: _enc_dec(P, normalize_before),
                          [src, tgt], run))


def test_transformer_masks_and_the_square_subsequent_mask():
    rng = np.random.default_rng(5)
    src, tgt = _n(rng, 2, 5, 8), _n(rng, 2, 4, 8)

    def run(P, lay, xs):
        m = lay.generate_square_subsequent_mask(4)
        assert str(m.dtype).endswith("float32") and m.shape == [4, 4]
        return lay(xs[0], xs[1], None, m, None)

    compare_runs(pair_run(
        lambda P: P.nn.Transformer(8, 2, 2, 2, 16, dropout=0.0),
        [src, tgt], run))
    jm = jpaddle.nn.Transformer(8, 2, 1, 1, 16)
    tm = tpaddle.nn.Transformer(8, 2, 1, 1, 16)
    np.testing.assert_array_equal(
        tm.generate_square_subsequent_mask(5).numpy(),
        np.asarray(jm.generate_square_subsequent_mask(5).numpy()))
    from paddle_tpu_torch.nn.layer.transformer import _convert_attention_mask
    mask = tpaddle.to_tensor(np.ones((2, 2), bool))
    assert _convert_attention_mask(mask, "float32") is mask
    assert _convert_attention_mask(None, "float32") is None


# -- dynamic_decode ----------------------------------------------------------

class _Seq2Seq:
    """An LSTM decoder: embedding, cell, output projection."""

    @staticmethod
    def build(P, V=8, H=4):
        nn = P.nn
        return nn.LayerList([nn.Embedding(V, H), nn.LSTMCell(H, H),
                             nn.Linear(H, V)])


def _table_model(P, table):
    """A cell whose logits are a row of ``table`` picked by the input
    token (ties by construction); its state is carried unchanged."""
    nn = P.nn

    class TableCell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.table = self.create_parameter(
                list(table.shape),
                default_initializer=nn.initializer.Assign(table))

        def forward(self, inputs, states):
            return P.gather(self.table, inputs), states

    return TableCell()


def _decode(P, kind, table=None, beam=3, B=2, max_steps=8):
    P.seed(0)
    if kind == "lstm":
        lay = _Seq2Seq.build(P)
        if P is tpaddle:
            lay.set_state_dict(_decode.ref_sd)
        else:
            _decode.ref_sd = {k: v.numpy()
                              for k, v in lay.state_dict().items()}
        dec = P.nn.BeamSearchDecoder(lay[1], start_token=0, end_token=1,
                                     beam_size=beam, embedding_fn=lay[0],
                                     output_fn=lay[2])
        rng = np.random.default_rng(6)
        h0 = P.to_tensor(rng.standard_normal((B, 4)).astype(np.float32))
        inits = (h0, h0 * 0.5)
    else:
        cell = _table_model(P, table)
        dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                     beam_size=beam)
        inits = P.zeros([B, 2])
    ids, lens = P.nn.dynamic_decode(dec, inits, max_step_num=max_steps)
    return np.asarray(ids.numpy()), np.asarray(lens.numpy()), ids, lens


def _tie_table(V):
    """Log-prob rows with exact ties: the start token spreads evenly, a
    few tokens end early, others tie among themselves."""
    t = np.full((V, V), -2.0, np.float32)
    t[:, 1] = 0.0                    # end_token likely from most rows
    t[0, :] = 0.0                    # start: every token tied
    t[2, 1] = -8.0                   # token 2 rarely ends
    t[2, 3:] = 1.0                   # ... and ties among 3.. instead
    return t


@pytest.mark.parametrize("kind,V,beam", [("lstm", 8, 3), ("tie", 6, 3),
                                         ("tie", 3, 4)])
def test_dynamic_decode_ids_and_lengths_equal_the_reference(kind, V, beam):
    table = None if kind == "lstm" else _tie_table(V)
    jids, jlens, _, _ = _decode(jpaddle, kind, table, beam)
    tids, tlens, ids, lens = _decode(tpaddle, kind, table, beam)
    assert tids.shape == jids.shape and ids.dtype == torch.int32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlens, jlens)
    assert lens.dtype == torch.int32
    if kind == "tie" and V > beam:
        # every beam finished before max_step_num: the loop stopped early
        assert tids.shape[1] < 8
        assert (tids == 1).any()


def test_dynamic_decode_time_major_and_no_impute():
    table = _tie_table(6)
    for P in (jpaddle, tpaddle):
        cell = _table_model(P, table)
        dec = P.nn.BeamSearchDecoder(cell, 0, 1, 3)
        a, _ = P.nn.dynamic_decode(dec, P.zeros([2, 2]), max_step_num=6,
                                   output_time_major=True,
                                   impute_finished=False)
        if P is jpaddle:
            want = np.asarray(a.numpy())
    np.testing.assert_array_equal(a.numpy(), want)
    with pytest.raises(ValueError, match="initial cell states"):
        tpaddle.nn.dynamic_decode(tpaddle.nn.BeamSearchDecoder(
            _table_model(tpaddle, table), 0, 1, 3), (), max_step_num=2)


def test_stable_top_k_breaks_ties_to_the_lower_index():
    from paddle_tpu_torch.nn.decode import top_k_stable
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, float("-inf")]])
    v, i = top_k_stable(x, 5)
    assert i.tolist() == [[1, 2, 4, 0, 3]]
    assert v[0, :4].tolist() == [3.0, 3.0, 3.0, 1.0]
