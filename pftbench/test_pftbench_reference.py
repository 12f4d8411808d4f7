"""The frozen references against the program's plain CPU path at a tiny size:
the forwards with the feature map, the class-wise EM and its
log-likelihood, the server head, the wire."""
import numpy as np
import pytest
import torch

from pftbench import testing, traffic, weights
from pftbench.reference import gmm as RG
from pftbench.reference import head as RH
from pftbench.reference import model as RM
from pftbench.reference import wire as RW


def _inputs(model, n, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    if model["family"] == "encoder":
        return torch.randn((n, S, model["frame_embed_dim"]), generator=g)
    return torch.randint(1, model["vocab_size"], (n, S), generator=g)


@pytest.mark.parametrize("model", [testing.ENCODER, testing.HYBRID])
def test_features_match_the_programs_cpu_path(model):
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    params = weights.make(model, 5, "cpu")
    inp = _inputs(model, 3, 24)
    key = "frames" if model["family"] == "encoder" else "tokens"
    want = M.features(ModelConfig(**model), params, {key: inp}, device="cpu")
    got = RM.features(model, params, inp)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(
        want.abs().max()))


def test_masked_mean_of_a_causal_model_is_the_unpadded_rows():
    params = weights.make(testing.HYBRID, 6, "cpu")
    inp = _inputs(testing.HYBRID, 3, 24)
    valid = torch.ones(3, 24, dtype=torch.bool)
    valid[1, 20:] = False
    short = RM.features(testing.HYBRID, params, inp[1:2, :20])
    assert torch.allclose(RM.features(testing.HYBRID, params, inp, valid)[1],
                          short[0], atol=1e-5)


def test_fp8_products_are_coarser_than_bf16():
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(64, 128, generator=g), torch.randn(128, 32, generator=g)
    exact = x @ w
    e8 = (RM.fp8_matmul(x, w) - exact).abs().max()
    e16 = ((x.bfloat16() @ w.bfloat16()).float() - exact).abs().max()
    assert e8 > 4 * e16


def _client(seed=3, n=60, d=12, C=3):
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn(C, d, generator=g) * 3
    y = torch.arange(n) % C
    return centers[y] + torch.randn(n, d, generator=g), y


def test_em_is_the_programs_from_the_same_stream():
    from repro_torch.core import gmm as G
    from repro_torch.fl import api as A
    x, y = _client()
    cfg = {"K": 2, "n_iter": 6, "kmeans_iter": 3, "reg": 1e-4}
    summ = A.GMMSummarizer(G.GMMConfig(n_components=2, n_iter=6,
                                       kmeans_iter=3, reg=1e-4))
    want, _, want_ll = summ.summarize(
        x, y, 3, generator=A.round_generator(99, 1, "cpu"))
    got, got_ll = RG.fit_client(x, y, 3, cfg, RG.round_generator(99, 1, "cpu"))
    for k in ("pi", "mu", "cov"):
        assert torch.allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    assert torch.allclose(got_ll, want_ll, rtol=1e-5)
    # the log-likelihood of given mixtures is the program's log_prob
    ll = RG.mean_loglik(x, y, 3, got)
    for c in range(3):
        lp = G.log_prob(x[y == c], {k: v[c] for k, v in got.items()}, "diag")
        assert torch.allclose(ll[c], lp.mean(), rtol=1e-5)


def test_head_is_the_programs_from_the_same_stream():
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    g = torch.Generator().manual_seed(4)
    G_, K, d, C = 6, 2, 8, 3
    pi = torch.softmax(torch.randn(G_, K, generator=g), -1)
    mu = torch.randn(G_, K, d, generator=g)
    cov = torch.rand(G_, K, d, generator=g) + 0.1
    counts = torch.tensor([5, 0, 7, 3, 4, 9], dtype=torch.int32)
    labels = torch.arange(G_) % C
    hc = H.HeadConfig(n_steps=30, batch_size=16, lr=1e-2, noise_window=8)
    want, _ = H.fused_gmm_steps(pi, mu, cov, labels, counts, C, hc, "diag",
                                generator=A.round_generator(7, 0, "cpu"))
    got = RH.train(pi, mu, cov, counts, C,
                      {"n_steps": 30, "batch": 16, "lr": 1e-2,
                       "noise_window": 8}, RG.round_generator(7, 0, "cpu"))
    for k in ("w", "b"):
        assert torch.allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_wire_reads_the_programs_payload():
    from repro_torch.fl import api as A
    x, y = _client(d=6)
    y = torch.where(y == 1, 0, y)                  # class 1 absent
    sess = A.FedSession(n_classes=3, summarizer=A.GMMSummarizer(
        A.G.GMMConfig(n_components=2, n_iter=3)))
    params, counts, lls = sess.client_summary(
        x, y, 0, generator=A.round_generator(5, 1, "cpu"), device="cpu")
    msg = sess.encode(params, counts, lls)
    sent = msg.header.counts
    assert sent[1] == 0
    assert len(msg.payload) == RW.payload_bytes(sent, 2, 6)
    dec = RW.decode(msg.payload, sent, 2, 6)
    for k in ("pi", "mu", "cov"):
        assert np.isnan(dec[k][1]).all()
        assert np.array_equal(dec[k][[0, 2]], msg.params[k][[0, 2]].numpy())


def test_traffic_seeds_the_programs_streams():
    from repro_torch.fl import api as A
    for seed in (0, 2**31 + 5, traffic.sub_seed(2**31, 2, 3)):
        for i in (0, 1, 4):
            a = A.round_generator(seed, i, "cpu")
            b = RG.round_generator(seed, i, "cpu")
            assert torch.equal(torch.rand(4, generator=a),
                               torch.rand(4, generator=b))
