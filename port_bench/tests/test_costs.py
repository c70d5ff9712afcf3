"""The operation and byte counts against small cases worked by hand."""
import pytest

from port_bench import costs


def test_least_seconds_takes_the_larger_bound():
    assert costs.least_seconds(495e12, 0, "fp32") == pytest.approx(1.0)
    assert costs.least_seconds(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert costs.least_seconds(989e12, 3.35e12 / 2, "bf16") == pytest.approx(1.0)
    assert costs.PEAK_FLOPS["fp32"] == 495e12          # TF32 tensor cores, never 67


@pytest.mark.parametrize("mode,ops", [
    # N=2, K=3, H=4: N*K*(4H^2 + 30H) + N*4H^2 = 6*(64+120) + 2*64
    ("enc_node", 6 * 184 + 128),
    ("dec", 6 * 184 + 128),
    # N*K*(6H^2 + 30H) + N*2H^2 = 6*(96+120) + 2*32
    ("enc_edge", 6 * 216 + 64),
])
def test_message_table_operations(mode, ops):
    assert costs.message_table(mode, 2, 3, 4, "fp32")[0] == ops


def test_message_table_bytes():
    # N=2, K=3, H=4, enc_node fp32: 4*(NH + NKH + NC + 2NK + 4H^2 + 3H + NH) + 8NK
    want = 4 * (8 + 24 + 8 + 12 + 64 + 12 + 8) + 8 * 6
    assert costs.message_table("enc_node", 2, 3, 4, "fp32")[1] == want
    # save_x writes N*K*H more; bf16 halves every element
    assert costs.message_table("enc_node", 2, 3, 4, "fp32", save_x=True)[1] == want + 4 * 24
    assert costs.message_table("enc_node", 2, 3, 4, "bf16")[1] == (want - 48) // 2 + 48


def test_message_table_backward():
    # N=1, K=2, H=2, dec: N*K*(10H^2 + 40H) + N*8H^2 = 2*(40+80) + 32
    assert costs.message_table_bwd("dec", 1, 2, 2, "fp32")[0] == 272
    # enc_edge: 2*(14*4 + 80) + 4*4
    assert costs.message_table_bwd("enc_edge", 1, 2, 2, "fp32")[0] == 288


def test_fused_updates():
    # node: N*K*(4H^2+30H) + N*(20H^2+20H) at N=1, K=2, H=2
    assert costs.fused_update("node_enc", 1, 2, 2, "fp32")[0] == 2 * 76 + 120
    # edge: N*K*(6H^2+38H) + N*2H^2
    assert costs.fused_update("edge", 1, 2, 2, "fp32")[0] == 2 * 100 + 8


def test_sampler_counts_one_position_per_row_and_step():
    # B=1, L=1, K=1, H=1, one layer, 1 letter: statics 2, per position
    # (6+30) + 2 + 16 + 20 + 0 + 2
    assert costs.sampler_flops(1, 1, 1, 1, 1, letters=1) == 2 + 76
    # doubling the rows doubles both parts
    assert costs.sampler_flops(2, 1, 1, 1, 1, letters=1) == 2 * 78


def test_pairs_per_edge():
    assert costs.pairs_per_edge([("A", "protein", 10)]) == 25
    assert costs.pairs_per_edge([("A", "protein", 1), ("B", "dna", 1)]) == pytest.approx(8.5 ** 2)


def test_train_counts_three_passes():
    cfg = {"NUM_NEIGHBORS": 2, "HIDDEN_DIM": 2, "NUM_ENCODER_LAYERS": 1,
           "NUM_DECODER_LAYERS": 1}
    fwd = (costs.features_flops(3, 2, 2, 4) + costs.encoder_flops(3, 2, 2, 1)
           + costs.decoder_flops(3, 2, 2, 1))
    assert costs.train_flops(3, 4, cfg) == 3 * fwd


def test_train_table_seconds_sums_nine_launches():
    cfg = {"MIXED_PRECISION": 1, "NUM_NEIGHBORS": 32, "HIDDEN_DIM": 128,
           "NUM_ENCODER_LAYERS": 3, "NUM_DECODER_LAYERS": 3}
    want = sum(3 * costs.least_seconds(*costs.message_table_bwd(m, 8 * 768, 32, 128, "bf16"),
                                       "bf16")
               for m in ("enc_node", "enc_edge", "dec"))
    assert costs.train_table_seconds(8 * 768, cfg, backward=True) == pytest.approx(want)
    # at bf16 the rows are bound by their bytes
    ops, nbytes = costs.message_table("dec", 8 * 768, 32, 128, "bf16", save_x=True)
    assert nbytes / costs.PEAK_BYTES > ops / costs.PEAK_FLOPS["bf16"]


CFG = {"NUM_NEIGHBORS": 2, "HIDDEN_DIM": 2, "NUM_ENCODER_LAYERS": 1,
       "NUM_DECODER_LAYERS": 1, "inference": {"score": {"batch_size": 3}}}


def test_score_counts_one_encode():
    # L=4 residues of protein, 3 orders: one encode, the decoder over the 3
    # orders and the unconditional pass (4 rows of L)
    chains = [("A", "protein", 4)]
    p = costs.pairs_per_edge(chains)
    want = (costs.features_flops(4, 2, 2, p) + costs.encoder_flops(4, 2, 2, 1)
            + costs.decoder_flops(16, 2, 2, 1))
    assert costs.serve_flops("score", chains, CFG) == want
    # twice the orders adds decoder work only
    more = dict(CFG, inference={"score": {"batch_size": 6}})
    extra = costs.decoder_flops(28, 2, 2, 1) - costs.decoder_flops(16, 2, 2, 1)
    assert costs.serve_flops("score", chains, more) == want + extra


def test_score_fused_seconds_counts_the_encoder_once():
    cfg = dict(CFG, NUM_NEIGHBORS=32, HIDDEN_DIM=128, NUM_ENCODER_LAYERS=3,
               NUM_DECODER_LAYERS=3)
    L, B = 389, 10

    def t(kind, n):
        return costs.least_seconds(*costs.fused_update(kind, n, 32, 128, "fp32"), "fp32")
    want = 3 * t("node_enc", L) + 3 * t("edge", L) + 3 * t("node_dec", B * L + L)
    assert costs.score_fused_seconds(L, B, cfg) == pytest.approx(want)
