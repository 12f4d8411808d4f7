"""Faults planted in the program under the timed path, which the comparison
has to catch: the CPU tests plant each at a tiny size, and
``python -m pftbench.control --fault <name>`` reads the cell's numbers with
one planted at the cell's own size.  Each takes ``patch(obj, name, value)``,
such as ``setattr`` or pytest's ``monkeypatch.setattr``."""
from __future__ import annotations

import dataclasses


def em_unchanged(patch) -> None:
    """The client's EM returns its state unchanged: every fit keeps its
    k-means start, and reports that start's log-likelihood."""
    from repro_torch.core import gmm as G
    orig = G.fit_gmm_batch

    def fit(x, weights, cfg, **kw):
        return orig(x, weights, dataclasses.replace(cfg, n_iter=0), **kw)
    patch(G, "fit_gmm_batch", fit)


def labels_shifted(patch) -> None:
    """The served head's logits move one row down the step's batch: each
    inference request gets the label of the row before it."""
    from repro_torch.core import head as H
    orig = H.head_logits
    patch(H, "head_logits", lambda params, feats:
          orig(params, feats).roll(1, 0))


def wire_altered(patch) -> None:
    """The wire carries every mean 5 % off the client's."""
    from repro_torch.fl import api as A
    orig = A.encode_message

    def encode(params, *a, **k):
        params = dict(params)
        params["mu"] = params["mu"] * 1.05
        return orig(params, *a, **k)
    patch(A, "encode_message", encode)


FAULTS = {"em_unchanged": em_unchanged, "labels_shifted": labels_shifted,
          "wire_altered": wire_altered}
