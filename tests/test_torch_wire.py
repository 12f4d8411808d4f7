"""The port's wire and planner against ``repro/fl/api.py`` / ``planner.py``.

The wire is exact: for the same parameters the port's payload is
byte-identical to the reference's, each side's ``decode_payload`` decodes
the other's payload to the same arrays, and the fused slot stack and the
planner's slot table agree element for element.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fl import api as JA
from repro.fl import planner as JP
from repro_torch.core import gmm as G
from repro_torch.fl import api as A
from repro_torch.fl import planner as P


def _gmm_params(seed, C=4, K=3, d=5, cov="diag"):
    rng = np.random.RandomState(seed)
    params = {"pi": rng.dirichlet(np.ones(K), C).astype(np.float32),
              "mu": (rng.randn(C, K, d) * 3).astype(np.float32),
              "cov": (rng.rand(*((C, K, d) if cov == "diag" else (C, K)))
                      + 0.05).astype(np.float32)}
    counts = np.asarray([5, 0, 12, 1][:C], np.int64)
    lls = rng.randn(C).astype(np.float32)
    return params, counts, lls


def _port_header(h):
    return A.WireHeader(**dataclasses.asdict(h))


def _ref_header(h):
    return JA.WireHeader(**dataclasses.asdict(h))


class TestWireIsExact:
    @pytest.mark.parametrize("cov", ["diag", "spher"])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
    def test_payload_byte_identical(self, cov, dtype):
        params, counts, lls = _gmm_params(1, cov=cov)
        kw = dict(kind="gmm", cov_type=cov, n_classes=4)
        mj = JA.encode_message(params, counts, lls,
                               codec=JA.QuantizedCodec(dtype), **kw)
        mt = A.encode_message({k: torch.from_numpy(v)
                               for k, v in params.items()},
                              torch.from_numpy(counts),
                              torch.from_numpy(lls),
                              codec=A.QuantizedCodec(dtype), **kw)
        assert mt.payload == mj.payload
        assert dataclasses.asdict(mt.header) == dataclasses.asdict(mj.header)
        assert mt.comm_bytes == mj.comm_bytes == G.comm_bytes(
            cov, 5, 3, 3, A.QuantizedCodec(dtype).bytes_per_scalar)
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(mt.params[f].numpy(),
                                          np.asarray(mj.params[f]))
        np.testing.assert_allclose(mt.logliks, mj.logliks)

    @pytest.mark.parametrize("cov", ["diag", "spher"])
    def test_each_side_decodes_the_other(self, cov):
        params, counts, lls = _gmm_params(2, cov=cov)
        kw = dict(kind="gmm", cov_type=cov, n_classes=4)
        mj = JA.encode_message(params, counts, lls,
                               codec=JA.QuantizedCodec(), **kw)
        mt = A.encode_message({k: torch.from_numpy(v)
                               for k, v in params.items()}, counts, lls,
                              codec=A.QuantizedCodec(), **kw)
        from_ref, err1 = A.decode_payload(_port_header(mj.header), mj.payload)
        from_port, err2 = JA.decode_payload(_ref_header(mt.header),
                                            mt.payload)
        assert err1 is None and err2 is None
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(from_ref[f], from_port[f])
            np.testing.assert_array_equal(from_ref[f],
                                          np.asarray(mj.params[f]))

    def test_bf16_rounds_to_nearest_even(self):
        """Ties at bf16 precision: 1 + 2⁻⁸ rounds down to 1 (even), 1 + 3·2⁻⁸
        up to 1 + 2⁻⁶; the bytes equal the reference's ml_dtypes cast."""
        vals = np.asarray([1 + 2 ** -8, 1 + 3 * 2 ** -8, -2.5, 1e-40,
                           65504.0], np.float32)
        codec_t, codec_j = A.QuantizedCodec(), JA.QuantizedCodec()
        bt = codec_t.encode({"a": torch.from_numpy(vals)}, ["a"])
        assert bt == codec_j.encode({"a": vals}, ["a"])
        back = codec_t.decode(bt, {"a": (5,)}, ["a"])["a"]
        assert back[0] == 1.0 and back[1] == 1 + 2 ** -6

    def test_decode_payload_flags_bad_input(self):
        params, counts, lls = _gmm_params(3)
        m = A.encode_message(params, counts, lls, kind="gmm",
                             cov_type="diag", n_classes=4,
                             codec=A.QuantizedCodec())
        out, err = A.decode_payload(m.header, m.payload[:-2])
        assert out is None and err.startswith("length_mismatch")
        bad = {k: v.copy() for k, v in params.items()}
        bad["mu"][0, 0, 0] = np.nan
        mb = A.encode_message(bad, counts, lls, kind="gmm", cov_type="diag",
                              n_classes=4, codec=A.QuantizedCodec())
        out, err = A.decode_payload(mb.header, mb.payload)
        assert out is not None and err.startswith("non_finite")
        hdr = dataclasses.replace(m.header, kind="head")
        assert A.decode_payload(hdr, m.payload)[0] is None

    def test_full_covariance_and_head_messages_refused(self):
        """Full-covariance and head messages both go on the wire: their
        payloads are byte-identical to the reference's and decode to the
        same parameters (a full cov as its row-major lower triangle)."""
        params, counts, lls = _gmm_params(4)
        rng = np.random.RandomState(4)
        a = rng.randn(4, 3, 5, 5).astype(np.float32)
        params["cov"] = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
        head = {"w": rng.randn(5, 4).astype(np.float32),
                "b": rng.randn(4).astype(np.float32)}
        for kind, p, cov in (("gmm", params, "full"), ("head", head, "")):
            kw = dict(kind=kind, cov_type=cov, n_classes=4)
            mj = JA.encode_message(p, counts, lls,
                                   codec=JA.QuantizedCodec(), **kw)
            mt = A.encode_message({k: torch.from_numpy(v)
                                   for k, v in p.items()}, counts, lls,
                                  codec=A.QuantizedCodec(), **kw)
            assert mt.payload == mj.payload
            assert dataclasses.asdict(mt.header) == \
                dataclasses.asdict(mj.header)
            for f in p:
                np.testing.assert_array_equal(mt.params[f].numpy(),
                                              np.asarray(mj.params[f]))
        assert mt.comm_bytes == (5 * 4 + 4) * 2


class TestFullCovarianceWire:
    @pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
    def test_full_payload_both_ways(self, dtype):
        """A full-cov payload from the port is the reference's, byte for
        byte, and each side's ``decode_payload`` decodes the other's."""
        params, counts, lls = _gmm_params(6)
        a = np.random.RandomState(6).randn(4, 3, 5, 5).astype(np.float32)
        params["cov"] = (a @ np.swapaxes(a, -1, -2) / 5).astype(np.float32)
        kw = dict(kind="gmm", cov_type="full", n_classes=4)
        mj = JA.encode_message(params, counts, lls,
                               codec=JA.QuantizedCodec(dtype), **kw)
        mt = A.encode_message({k: torch.from_numpy(v)
                               for k, v in params.items()}, counts, lls,
                              codec=A.QuantizedCodec(dtype), **kw)
        assert mt.payload == mj.payload
        assert mt.comm_bytes == G.comm_bytes(
            "full", 5, 3, 3, A.QuantizedCodec(dtype).bytes_per_scalar)
        from_ref, e1 = A.decode_payload(_port_header(mj.header), mj.payload)
        from_port, e2 = JA.decode_payload(_ref_header(mt.header), mt.payload)
        assert e1 is None and e2 is None
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(from_ref[f], from_port[f])
            np.testing.assert_array_equal(mt.params[f].numpy(), from_ref[f])
        cov = mt.params["cov"].numpy()
        np.testing.assert_array_equal(cov, np.swapaxes(cov, -1, -2))


class TestSlotStackAndPlanner:
    def test_fused_slot_stack_matches_reference(self):
        msgs_j, msgs_t = [], []
        for s in range(3):
            params, counts, lls = _gmm_params(10 + s)
            counts = np.roll(counts, s)
            kw = dict(kind="gmm", cov_type="diag", n_classes=4)
            msgs_j.append(JA.encode_message(params, counts, lls,
                                            codec=JA.QuantizedCodec(), **kw))
            msgs_t.append(A.encode_message(params, counts, lls,
                                           codec=A.QuantizedCodec(), **kw))
        counts = np.stack([m.counts for m in msgs_t])
        sj, lj, cj, _ = JA.fused_slot_stack(JA.stack_messages(msgs_j), counts)
        st, lt, ct, plan = A.fused_slot_stack(A.stack_messages(msgs_t), counts)
        for f in G.WIRE_FIELDS:
            np.testing.assert_array_equal(st[f].numpy(), np.asarray(sj[f]))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert len(plan.slot_table) == int((counts > 0).sum())

    @pytest.mark.parametrize("policy,spc", [("pow2", None), ("single", None),
                                            ("pow2", 7)])
    def test_planner_matches_reference(self, policy, spc):
        counts = np.random.RandomState(5).randint(0, 40, (5, 6))
        pt = P.plan_synthesis(counts, spc, policy)
        pj = JP.plan_synthesis(counts, spc, policy)
        assert (pt.requested, pt.padded_draws, pt.n_dispatches) == \
            (pj.requested, pj.padded_draws, pj.n_dispatches)
        for a, b in zip((pt.slot_table.slots, pt.slot_table.counts,
                         pt.slot_table.cum_mass),
                        (pj.slot_table.slots, pj.slot_table.counts,
                         pj.slot_table.cum_mass)):
            np.testing.assert_array_equal(a, b)
