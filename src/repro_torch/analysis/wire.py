"""WIRE-CONTRACT: the wire layout agrees *by construction*, not convention
(port of ``repro/analysis/wire.py``).

The paper's comm accounting (Eqs. 9-11) is exact only while three things
stay one definition: the field order (``gmm.WIRE_FIELDS``), the packed
covariance shape (``gmm.packed_cov_shape`` / ``tril_pack``), and the byte
length the codec actually produces (``ClientMessage.comm_bytes ==
len(payload) == gmm.comm_bytes``).  This rule imports the live modules
and re-verifies each identity on real round trips, per cov type, on the
device the semantic rules run on:

* ``fl.api._GMM_FIELDS`` must BE ``gmm.WIRE_FIELDS`` (object identity —
  a copied tuple can silently drift on the next edit);
* ``_pack_cov`` output shape equals ``packed_cov_shape`` for every cov
  type, and tril_pack/tril_unpack round-trip;
* an encoded GMM message's params hold exactly the wire fields;
* ``msg.comm_bytes == len(msg.payload) == gmm.comm_bytes(...)`` for the
  message's (cov_type, d, K, C present);
* encode → decode → re-encode is byte-identical (the codec is a true
  fixed point after one quantization).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.analysis.core import (Finding, SemanticRule, Severity,
                                       SourceFile)


class WireContractRule(SemanticRule):
    id = "WIRE-CONTRACT"
    severity = Severity.ERROR
    doc = ("ClientMessage fields, WIRE_FIELDS and packed_cov_shape agree "
           "by construction (identity + live round trips per cov type)")
    reference = "WIRE-CONTRACT"
    hazard = "comm accounting (Eqs. 9-11) drifting from the bytes sent"
    anchors = ("repro_torch/fl/api.py", "repro_torch/core/gmm.py")

    def __init__(self, api=None, gmm=None):
        # the modules checked (tests hand in mutated copies)
        self.api, self.gmm = api, gmm

    def run_project(self, files: Sequence[SourceFile], device: str):
        import numpy as np
        import torch

        api_src = self.anchor(files, self.anchors[0])
        gmm_src = self.anchor(files, self.anchors[1])
        src = api_src or gmm_src
        if src is None:
            return []
        findings: List[Finding] = []

        def flag(anchor_src: Optional[SourceFile], needle, msg, hint):
            s = anchor_src or src
            findings.append(self.finding(s, s.line_of(needle), msg, hint))

        if self.api is None or self.gmm is None:
            from repro_torch.core import gmm as G
            from repro_torch.fl import api as FA
        G = self.gmm or G
        FA = self.api or FA

        if FA._GMM_FIELDS is not G.WIRE_FIELDS:
            flag(api_src, "_GMM_FIELDS",
                 "fl.api._GMM_FIELDS is not gmm.WIRE_FIELDS (object "
                 "identity) — a copied layout tuple can drift",
                 "alias it: _GMM_FIELDS = G.WIRE_FIELDS")

        rng = np.random.RandomState(0)
        dev = torch.device(device)
        C, K, d = 3, 2, 4
        for cov_type in G.COV_TYPES:
            if cov_type == "full":
                a = rng.randn(C, K, d, d).astype(np.float32)
                cov = a @ a.transpose(0, 1, 3, 2) + d * np.eye(
                    d, dtype=np.float32)
            elif cov_type == "diag":
                cov = rng.rand(C, K, d).astype(np.float32) + 0.5
            else:
                cov = rng.rand(C, K).astype(np.float32) + 0.5
            cov_t = torch.from_numpy(cov).to(dev)
            packed = FA._pack_cov(cov_t, cov_type)
            want = (C,) + tuple(G.packed_cov_shape(cov_type, K, d))
            if tuple(packed.shape) != want:
                flag(api_src, "def _pack_cov",
                     f"_pack_cov({cov_type}) produced shape "
                     f"{tuple(packed.shape)} but packed_cov_shape says "
                     f"{want} — the accounting and the bytes disagree",
                     "make both delegate to gmm.packed_cov_shape")
            if cov_type == "full":
                rt = G.tril_unpack(packed.float(), d)
                if not torch.allclose(rt, cov_t, atol=1e-6):
                    flag(gmm_src, "def tril_unpack",
                         "tril_pack → tril_unpack is not the identity on "
                         "symmetric matrices",
                         "one row-major tril layout, one inverse")

            params = {
                "pi": torch.from_numpy(rng.dirichlet(np.ones(K), C)
                                       .astype(np.float32)).to(dev),
                "mu": torch.from_numpy(rng.randn(C, K, d)
                                       .astype(np.float32)).to(dev),
                "cov": cov_t}
            counts = np.array([5, 0, 7][:C], np.int64)
            codec = FA.QuantizedCodec("bfloat16")
            msg = FA.encode_message(params, counts, (0.0,) * C, kind="gmm",
                                    cov_type=cov_type, n_classes=C,
                                    codec=codec)
            if set(msg.params) != set(G.WIRE_FIELDS):
                flag(api_src, "class ClientMessage",
                     f"GMM ClientMessage params {sorted(msg.params)} != "
                     f"WIRE_FIELDS {sorted(G.WIRE_FIELDS)}",
                     "the message must carry exactly the wire fields")
            Cp = int(np.sum(counts > 0))
            expected = G.comm_bytes(cov_type, d, K, Cp,
                                    codec.bytes_per_scalar)
            if not (msg.comm_bytes == len(msg.payload) == expected):
                flag(api_src, "def comm_bytes",
                     f"[{cov_type}] comm accounting drift: "
                     f"msg.comm_bytes={msg.comm_bytes}, "
                     f"len(payload)={len(msg.payload)}, "
                     f"gmm.comm_bytes={expected}",
                     "comm_bytes must equal the real payload length "
                     "(Eqs. 9-11)")
            # quantize→dequantize fixed point: re-encoding the decoded
            # params must reproduce the payload byte-for-byte.  The wire
            # carries present classes only; params scatter back to C rows.
            pr = torch.as_tensor(msg.header.present, device=dev)
            sub = {"pi": msg.params["pi"][pr], "mu": msg.params["mu"][pr],
                   "cov": FA._pack_cov(msg.params["cov"][pr], cov_type)}
            if codec.encode(sub, FA._GMM_FIELDS) != msg.payload:
                flag(api_src, "def encode",
                     f"[{cov_type}] encode(decode(payload)) != payload — "
                     "the codec is not a fixed point after one "
                     "quantization",
                     "decode must dequantize exactly what encode wrote")
        return findings
