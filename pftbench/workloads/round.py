"""Kind ``round``: a closed loop of back-to-back one-shot FedPFT rounds.

A round is the paper's Algorithm 1 as its users run it: each client turns its
rows into features with the frozen backbone (``models.model.features``, in
batches), then ``FedSession.run`` fits every client's class-wise mixtures,
encodes them on the wire and trains the server's head from them (Star
topology, fused server).  The window runs whole rounds and ends with the
round in flight when ``--seconds`` has passed; round r takes dataset
r mod ``pool`` of the mix and the round seed ``sub_seed(seed, 2, r)``.

Set-up makes the weights and the datasets on the device and runs one
features batch and one round on features of that batch's shape, so every
kernel and shape of the window is built and warm before it opens.

The comparison follows the last round stage by stage, each stage from the
program's own output of the stage before (``check``):

  feat_gap     sampled rows' features against the float32 reference forward,
               max over rows of max |f - f_ref| / max |f_ref|
  ll_gap       each fit's reported mean log-likelihood against the float32
               reference's of the mixture the reference reads off the wire's
               bytes, on the client's features: max |ll - ll_ref| /
               max(|ll_ref|, 1)
  em_gain      what one float32 reference EM step from each wire mixture
               adds to its class's mean log-likelihood on the client's
               features, nats a row and feature dimension, max over present
               classes: a mixture that the client's EM never moved from its
               start gains much
  head_gap     the server's head against the float32 reference head trained
               from the clients' wire mixtures and the round's server draws,
               max |delta| / max |ref| over w and b
  wire_bytes_off  |sum of payload lengths - Eqs. 9-11|, exact
  count_off    sum |sent counts - the clients' label counts|, exact
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from pftbench import traffic, weights, workcount
from pftbench.reference import gmm as RG
from pftbench.reference import head as RH
from pftbench.reference import model as RM
from pftbench.reference import wire as RW


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _span(name: str):
    return torch.profiler.record_function(f"pftbench.{name}")


def gmm_cfg(mix: Dict) -> Dict:
    f = mix["fedpft"]
    return {"K": f["K"], "n_iter": f["em_iters"],
            "kmeans_iter": f["kmeans_iters"], "reg": f["reg"]}


def head_cfg(mix: Dict) -> Dict:
    f = mix["fedpft"]
    return {"n_steps": f["head_steps"], "batch": f["head_batch"],
            "lr": f["head_lr"], "noise_window": f["noise_window"]}


def session(mix: Dict, **kw):
    """The program's FedSession for the mix's FedPFT settings; ``kw`` its
    further fields (a service's ingest and program cache)."""
    from repro_torch.core import gmm as G
    from repro_torch.core import head as H
    from repro_torch.fl import api as A
    f = mix["fedpft"]
    return A.FedSession(
        n_classes=mix["n_classes"],
        summarizer=A.GMMSummarizer(G.GMMConfig(
            n_components=f["K"], cov_type=f["cov_type"],
            n_iter=f["em_iters"], kmeans_iter=f["kmeans_iters"],
            reg=f["reg"])),
        codec=A.QuantizedCodec(f["wire"]),
        topology=A.Star(),
        head=H.HeadConfig(n_steps=f["head_steps"],
                          batch_size=f["head_batch"], lr=f["head_lr"],
                          noise_window=f["noise_window"]),
        synthesis=f["synthesis"], **kw)


class Rounds:
    """The cell's weights, datasets and session, and its rounds."""

    def __init__(self, model: Dict, mix: Dict, seed: int, device):
        from repro_torch.models.config import ModelConfig
        self.dev = torch.device(device)
        self.model, self.mix, self.seed = model, mix, seed
        self.cfg = ModelConfig(**model)
        self.key = "frames" if model["family"] == "encoder" else "tokens"
        self.params = weights.make(model, traffic.sub_seed(seed, 3),
                                   self.dev)
        self.pool = []
        for r in range(mix["pool"]):
            d = traffic.round_inputs(mix, seed, r)
            x = torch.from_numpy(d["x"]).to(self.dev)
            inp = traffic.model_inputs(x, mix, model)
            y = torch.from_numpy(d["labels"]).to(self.dev)
            self.pool.append([(inp[torch.from_numpy(i).to(self.dev)],
                               y[torch.from_numpy(i).to(self.dev)])
                              for i in d["clients"]])
        self.sess = session(mix)
        self.seq_len = int(self.pool[0][0][0].shape[1])

    def features(self, inp: torch.Tensor) -> torch.Tensor:
        from repro_torch.models import model as M
        bs = self.mix["batch"]
        return torch.cat([M.features(self.cfg, self.params,
                                     {self.key: inp[j:j + bs]},
                                     device=self.dev)
                          for j in range(0, inp.shape[0], bs)])

    def round_seed(self, r: int) -> int:
        return traffic.sub_seed(self.seed, 2, r)

    def run(self, r: int) -> Dict:
        """Round r: the clients' features, then ``FedSession.run``."""
        clients = self.pool[r % len(self.pool)]
        t0 = time.perf_counter()
        with _span("features"):
            feats = [self.features(inp) for inp, _ in clients]
            _sync(self.dev)
        t1 = time.perf_counter()
        with _span("fedsession"):
            res = self.sess.run([(f, y) for f, (_, y) in zip(feats, clients)],
                                seed=self.round_seed(r),
                                device=str(self.dev))
        _sync(self.dev)
        return {"r": r, "feats": feats, "res": res,
                "phase": {"features_s": t1 - t0, **res.info["phase_s"]}}

    def warm_up(self) -> None:
        """One features batch, then one round on features of that batch
        tiled to the clients' rows: every shape of the window."""
        clients = self.pool[0]
        bs = self.mix["batch"]
        f = self.features(clients[0][0][:bs])
        rows = clients[0][0].shape[0]
        tiled = f.repeat(-(-rows // bs), 1)[:rows]
        self.sess.run([(tiled, y) for _, y in clients],
                      seed=traffic.sub_seed(self.seed, 5), device=str(self.dev))
        _sync(self.dev)


# ---- the comparison -------------------------------------------------------


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def feature_rows(rounds: Rounds, n_rows: int) -> np.ndarray:
    """The rows of a round whose features are compared, drawn from the seed
    (indices into the clients' rows laid end to end)."""
    n = sum(inp.shape[0] for inp, _ in rounds.pool[0])
    rng = np.random.RandomState(traffic.sub_seed(rounds.seed, 4) % (1 << 32))
    return np.sort(rng.choice(n, size=min(n_rows, n), replace=False))


def feat_gap(rounds: Rounds, r: int, rows: np.ndarray, got: torch.Tensor,
             mm=RM.f32_matmul, block: int = 8) -> float:
    """max over ``rows`` of max |got - ref| / max |ref| per row; ``got``
    (len(rows), d) the checked side's features of those rows."""
    inp = torch.cat([i for i, _ in rounds.pool[r % len(rounds.pool)]])
    idx = torch.from_numpy(rows).to(rounds.dev)
    gaps = []
    for j in range(0, len(rows), block):
        ref = RM.features(rounds.model, rounds.params, inp[idx[j:j + block]],
                          mm=mm)
        g = got[j:j + block].float()
        gaps.append(((g - ref).abs().amax(-1)
                     / ref.abs().amax(-1).clamp_min(1e-30)).max())
    return float(torch.stack(gaps).max())


def ll_gap(rounds, feats: torch.Tensor, labels: torch.Tensor,
           mix_got: Dict[str, torch.Tensor], ll_got: torch.Tensor) -> float:
    """A client's reported mean log-likelihoods against the float32
    reference's of the mixtures as read off the wire (float32), on the
    client's own features, over its present classes: max |ll - ll_ref| /
    max(|ll_ref|, 1)."""
    C = rounds.mix["n_classes"]
    present = torch.bincount(labels.long(), minlength=C) > 0
    mix = {k: torch.where(present.reshape((C,) + (1,) * (v.dim() - 1)), v,
                          torch.ones_like(v)) for k, v in mix_got.items()}
    ll = RG.mean_loglik(feats, labels, C, mix)
    return float(((ll_got - ll).abs() / ll.abs().clamp_min(1.0))[present]
                 .max())


def em_gain(rounds, feats: torch.Tensor, labels: torch.Tensor,
            mix_got: Dict[str, torch.Tensor]) -> float:
    """The largest gain in mean log-likelihood, nats a row and feature
    dimension, that one float32 reference EM step from a client's sent
    mixtures makes on its present classes."""
    C = rounds.mix["n_classes"]
    present = torch.bincount(labels.long(), minlength=C) > 0
    mix = {k: torch.where(present.reshape((C,) + (1,) * (v.dim() - 1)), v,
                          torch.ones_like(v)) for k, v in mix_got.items()}
    gain = RG.em_gain(feats, labels, C, mix, rounds.mix["fedpft"]["reg"])
    return float(gain[present].max()) / feats.shape[1]


def worst(*values: float) -> float:
    """The largest of ``values``; NaN where any is NaN (a number that could
    not be computed fails)."""
    return float("nan") if any(v != v for v in values) else max(values)


def wire_mix(rounds, msg, d: int) -> Dict[str, torch.Tensor]:
    """A message's mixtures as the reference reads them off its bytes."""
    return {k: torch.from_numpy(v).to(rounds.dev) for k, v in RW.decode(
        msg.payload, msg.header.counts, rounds.mix["fedpft"]["K"], d).items()}


def slot_grid(rounds, mixes: List[Dict[str, torch.Tensor]],
              counts: List[np.ndarray]):
    """The server's slot grid (pi, mu, cov, counts), client by client and
    class by class; an absent class's slot is never drawn."""
    K = rounds.mix["fedpft"]["K"]
    grid = {k: torch.cat([m[k] for m in mixes]) for k in ("pi", "mu", "cov")}
    absent = ~torch.isfinite(grid["pi"]).all(-1)
    for k, fill in (("pi", 1.0 / K), ("mu", 0.0), ("cov", 0.0)):
        grid[k][absent] = fill
    cnt = torch.from_numpy(np.concatenate(counts)).to(rounds.dev)
    return grid["pi"], grid["mu"], grid["cov"], cnt


def ref_head(rounds, seed: int, mixes, counts,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The reference head of the round seeded ``seed`` from the clients'
    wire mixtures and the round's server draws, trained in ``dtype``."""
    g = RG.round_generator(seed, 0, rounds.dev)
    return RH.train(*slot_grid(rounds, mixes, counts),
                    rounds.mix["n_classes"], head_cfg(rounds.mix), g, dtype)


def head_gap(rounds, seed: int, mixes: List[Dict[str, torch.Tensor]],
             counts: List[np.ndarray], got: Dict[str, torch.Tensor]) -> float:
    """The checked head against the float32 reference head of the round
    seeded ``seed``."""
    return param_gap(got, ref_head(rounds, seed, mixes, counts))


def param_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> float:
    """max |got - ref| / max |ref| over a head's w and b."""
    want = torch.cat([ref["w"].reshape(-1), ref["b"]])
    have = torch.cat([got["w"].reshape(-1).float(), got["b"].float()])
    return _rel(have, want)


def check(rounds: Rounds, out: Dict) -> Dict[str, float]:
    """Every compared number of the program's round ``out``."""
    r, feats, res = out["r"], out["feats"], out["res"]
    mix, C, K = rounds.mix, rounds.mix["n_classes"], rounds.mix["fedpft"]["K"]
    d = feats[0].shape[1]
    clients = rounds.pool[r % len(rounds.pool)]
    rows = feature_rows(rounds, mix["check"]["feature_rows"])
    nums = {"feat_gap": feat_gap(rounds, r, rows, torch.cat(feats)[
        torch.from_numpy(rows).to(rounds.dev)])}
    mixes, counts = [], []
    wire_off = count_off = 0
    ll = gain = 0.0
    for i, ((_, y), f, msg) in enumerate(zip(clients, feats, res.messages)):
        sent = np.asarray(msg.header.counts, np.int64)
        true = np.bincount(y.cpu().numpy(), minlength=C)
        count_off += int(np.abs(sent - true).sum())
        wire_off += abs(len(msg.payload) - RW.payload_bytes(sent, K, d))
        dec = wire_mix(rounds, msg, d)
        lls = torch.tensor(msg.logliks, dtype=torch.float32, device=rounds.dev)
        ll = worst(ll, ll_gap(rounds, f, y, dec, lls))
        gain = worst(gain, em_gain(rounds, f, y, dec))
        mixes.append(dec)
        counts.append(sent)
    nums.update(ll_gap=ll, em_gain=gain,
                head_gap=head_gap(rounds, rounds.round_seed(r), mixes, counts,
                                  res.model),
                wire_bytes_off=float(wire_off), count_off=float(count_off))
    return nums


# ---- one run of the cell --------------------------------------------------


def run(cell: Dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    """Set-up, the window and the comparison; the run's record."""
    from repro_torch.kernels import ops
    model, mix = cell["config_file"]["model"], cell["mix"]
    dev = torch.device(device)
    rounds = Rounds(model, mix, seed, dev)
    rounds.warm_up()
    _sync(dev)
    rec: Dict = {"kind": "round", "setup_s": time.perf_counter() - t_start}

    phases: List[Dict] = []
    calls: List = []
    n = 0
    out = None

    def window():
        nonlocal n, out
        t0 = time.perf_counter()
        while True:
            out = rounds.run(n)
            phases.append(out["phase"])
            n += 1
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    if trace:
        from torch.profiler import ProfilerActivity, profile
        from pftbench import trace as T
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof, ops.record_calls() as calls:
            rec["window_s"] = window()
        rec["trace"] = T.read(prof)
        del prof
    else:
        rec["window_s"] = window()
    rows = mix["n_clients"] * mix["rows_per_client"]
    rec.update(attempted=n, failed=0, samples=n * rows, phases=phases,
               model_flops=n * rows * workcount.model_flops(
                   model, rounds.seq_len))
    if trace:
        rec["bound_s"] = bound_seconds(calls, n, mix, model)
    if dev.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    rec["out"] = out
    rec["rounds_state"] = rounds
    return rec


def bound_seconds(calls, n_rounds: int, mix: Dict, model: Dict) -> Dict:
    """Each kernel's least time over the window's calls: flash and ssd from
    their recorded call shapes; the E-step from the EM's own work, whatever
    the launches that carry it: each round, each client's C fits of K
    components over its rows, ``em_iters`` E-steps and the final
    log-likelihood's."""
    out = {"flash_attention": 0.0, "ssd": 0.0}
    for c in calls:
        if c.name == "attention":
            q, k = c.tensors[0].shape, c.tensors[1].shape
            kw = dict(c.kw)
            out["flash_attention"] += workcount.bound_s(workcount.flash_work(
                q[0], q[1], k[1], q[2], k[2], q[3], causal=kw["causal"],
                window=kw["window"],
                elem_bytes=c.tensors[0].dtype.itemsize))
        elif c.name == "ssd":
            x, Bm = c.tensors[0].shape, c.tensors[2].shape
            out["ssd"] += workcount.bound_s(workcount.ssd_work(
                x[0], x[1], x[2], x[3], Bm[2], chunk=dict(c.kw)["chunk"],
                elem_bytes=c.tensors[0].dtype.itemsize))
    f = mix["fedpft"]
    out["estep_fused"] = (n_rounds * mix["n_clients"] * (f["em_iters"] + 1)
                          * workcount.bound_s(workcount.estep_fused_work(
                              1, mix["n_classes"], mix["rows_per_client"],
                              f["K"], model["d_model"])))
    return {k: v for k, v in out.items() if v > 0}


def compare(rec: Dict) -> Dict[str, float]:
    """The numbers of the run's last round; the program's round state is
    dropped first, so the reference runs beside the weights and the last
    round's outputs alone."""
    rounds, out = rec.pop("rounds_state"), rec.pop("out")
    return check(rounds, out)
