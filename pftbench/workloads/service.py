"""Kind ``service``: ``FedPFTService`` under an open loop of requests.

Requests arrive on a schedule drawn from the seed (``traffic.open_loop``),
whether or not earlier ones are done: extraction requests (a client's
prompt; its features come back) and inference requests (a prompt; the
served head's label comes back).  One thread drives the service: it submits
every request that is due, runs ``FedPFTService.step`` while a queue waits,
and sleeps to the next due time when none does.  When the last of a
client's extraction requests is served, it fits and sends the client's
message inside the window (``client_update`` then ``submit_update``).  Each
request's latency runs from its due time to its result.  The window is
every request due within ``--seconds``; it closes when the last is served.

Set-up makes the weights on the device, captures the service's round
program (``warmup``), runs one step at each prompt bucket the traffic can
reach (128, 256, 512 for prompts of 128 to 512) with the extraction
requests of one client, fits and
sends that client and closes the round (the served head), runs one
inference step, and fits one client of the window's size.

The comparison (``check``), after the window:

  feat_gap     sampled served extraction rows' features against the float32
               reference's masked mean over their prompts
  head_gap     the served head against the float32 reference head of the
               set-up round (its client's wire mixtures, its server draws)
  label_gap    sampled inference requests: how far the served label's logit
               lies below the best under the reference's features and head,
               as a share of the logits' range, max over the requests
  ll_gap, em_gain, wire_bytes_off, count_off
               the messages sent in the window, as in ``round``, on the
               clients' served features
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from pftbench import traffic, weights, workcount
from pftbench.reference import model as RM
from pftbench.reference import wire as RW
from pftbench.workloads import round as R

EXTRACT, INFER = 0, 1


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Service:
    """The cell's weights, service and traffic, and its window."""

    def __init__(self, model: Dict, mix: Dict, seed: int, seconds: float,
                 device):
        from repro_torch.fl import ingest as IG
        from repro_torch.launch.aot_cache import ProgramCache
        from repro_torch.models.config import ModelConfig
        from repro_torch.serve.service import FedPFTService, ServiceConfig
        self.dev = torch.device(device)
        self.model, self.mix, self.seed = model, mix, seed
        self.cfg = ModelConfig(**model)
        self.params = weights.make(model, traffic.sub_seed(seed, 3), self.dev)
        s = mix["service"]
        self.sess = R.session(
            mix, ingest=IG.IngestConfig(**mix["ingest"]),
            program_cache=ProgramCache() if self.dev.type == "cuda" else None)
        self.svc = FedPFTService(
            self.cfg, self.params, self.sess,
            ServiceConfig(n_slots=s["n_slots"], max_seq=s["max_seq"],
                          extract_share=s["extract_share"]),
            device=str(self.dev))
        self.plan = traffic.open_loop(mix, seed, seconds)
        n = len(self.plan["due"])
        self.tokens, self.labels = traffic.service_inputs(mix, seed, n, 0)
        self.messages: List = []

    def prompt(self, i: int) -> np.ndarray:
        return self.tokens[i, :int(self.plan["length"][i])]

    def client_update(self, feats, labels, i: int, seed: int):
        from repro_torch.fl import api as A
        return self.sess.client_update(
            torch.as_tensor(feats).to(self.dev),
            torch.as_tensor(labels).to(self.dev), i,
            generator=A.round_generator(seed, 1 + i, self.dev),
            device=self.dev)

    def warm_up(self) -> None:
        """The round program, each bucket's feature step, a served head,
        an inference step and a client fit of the window's size."""
        svc, mix = self.svc, self.mix
        self.svc.warmup(d=self.model["d_model"])
        B = mix["service"]["n_slots"]
        buckets = []
        b = 1 << (mix["len_min"] - 1).bit_length()
        while b < 2 * mix["len_max"]:
            buckets.append(min(b, mix["len_max"]))
            b *= 2
        tok, y = traffic.service_inputs(mix, self.seed, len(buckets) * B, 1)
        reqs = []
        for j in range(len(buckets) * B):
            reqs.append(svc.submit_extract(tok[j, :buckets[j // B]]))
            if len(reqs) % B == 0:
                svc.step()
        feats = np.stack([r.feats for r in reqs])
        head_seed = traffic.sub_seed(self.seed, 6)
        msg = self.client_update(feats, y, 0, head_seed)
        svc.submit_update(0, msg)
        svc.close_round(seed=head_seed)
        self.head_round = (msg, head_seed)
        svc.submit_infer(tok[0, :mix["len_min"]])
        svc.step()
        n = mix["rows_per_client"]
        self.client_update(np.resize(feats, (n, feats.shape[1])),
                           np.resize(y, n), 1, traffic.sub_seed(self.seed, 8))
        _sync(self.dev)

    def window(self) -> Dict:
        """The open loop: every request's result and its latency from its
        due time."""
        svc, plan, mix = self.svc, self.plan, self.mix
        due, kind = plan["due"], plan["kind"]
        n = len(due)
        reqs: List = [None] * n
        by_client: Dict[int, List[int]] = {}
        for i in np.flatnonzero(kind == EXTRACT):
            by_client.setdefault(int(plan["client"][i]), []).append(int(i))
        full = {c for c, rows in by_client.items()
                if len(rows) == mix["rows_per_client"]}
        sent = set()
        steps, step_s, rows = 0, 0.0, 0
        wseed = traffic.sub_seed(self.seed, 9)
        t0 = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter() - t0
            while i < n and due[i] <= now:
                p = self.prompt(i)
                reqs[i] = (svc.submit_extract(p) if kind[i] == EXTRACT
                           else svc.submit_infer(p))
                i += 1
            if svc.queues["extract"] or svc.queues["infer"]:
                s0 = time.perf_counter()
                rows += svc.step()
                step_s += time.perf_counter() - s0
                steps += 1
                for c in sorted(full - sent):
                    if all(reqs[j] is not None and reqs[j].done
                           for j in by_client[c]):
                        idx = by_client[c]
                        msg = self.client_update(
                            np.stack([reqs[j].feats for j in idx]),
                            self.labels[idx], c, wseed)
                        svc.submit_update(c, msg)
                        self.messages.append((c, idx, msg))
                        sent.add(c)
            elif i < n:
                time.sleep(max(0.0, due[i] - (time.perf_counter() - t0)))
            else:
                break
        window_s = time.perf_counter() - t0
        lat = np.asarray([reqs[j].t_done - t0 - due[j]
                          if reqs[j] is not None and reqs[j].done else np.inf
                          for j in range(n)])
        return {"reqs": reqs, "latency_s": lat, "window_s": window_s,
                "steps": steps, "step_s": step_s, "rows": rows,
                "wseed": wseed}


def run(cell: Dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    model, mix = cell["config_file"]["model"], cell["mix"]
    dev = torch.device(device)
    svc = Service(model, mix, seed, seconds, dev)
    svc.warm_up()
    rec: Dict = {"kind": "service", "setup_s": time.perf_counter() - t_start}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from pftbench import trace as T
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            out = svc.window()
        rec["trace"] = T.read(prof)
        del prof
    else:
        out = svc.window()
    kind, length = svc.plan["kind"], svc.plan["length"]
    lat = out["latency_s"]
    rec.update(window_s=out["window_s"], attempted=len(lat),
               failed=int(np.isinf(lat).sum()),
               extract_latency_s=lat[kind == EXTRACT],
               infer_latency_s=lat[kind == INFER],
               steps=out["steps"], step_s=out["step_s"], rows=out["rows"],
               model_flops=sum(workcount.model_flops(model, int(L))
                               for L in length))
    if dev.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    rec["state"] = (svc, out)
    return rec


# ---- the comparison -------------------------------------------------------


def sample(svc: Service, kind: int, n: int) -> np.ndarray:
    """The requests of ``kind`` whose results are compared, drawn from the
    seed."""
    idx = np.flatnonzero(svc.plan["kind"] == kind)
    rng = np.random.RandomState(
        traffic.sub_seed(svc.seed, 10 + kind) % (1 << 32))
    return np.sort(rng.choice(idx, size=min(n, len(idx)), replace=False))


def ref_features(svc: Service, idx: np.ndarray, mm=RM.f32_matmul,
                 block: int = 8) -> torch.Tensor:
    """The reference's masked-mean features of requests ``idx``."""
    out = []
    for j in range(0, len(idx), block):
        part = idx[j:j + block]
        L = svc.plan["length"][part]
        tok = np.zeros((len(part), int(L.max())), np.int64)
        for k, i in enumerate(part):
            tok[k, :L[k]] = svc.prompt(int(i))
        valid = torch.arange(tok.shape[1])[None] < torch.from_numpy(L)[:, None]
        out.append(RM.features(svc.model, svc.params,
                               torch.from_numpy(tok).to(svc.dev),
                               valid.to(svc.dev), mm=mm))
    return torch.cat(out)


def served_head(svc: Service, dtype: torch.dtype = torch.float32
                ) -> Dict[str, torch.Tensor]:
    """The reference head of the set-up round, trained in ``dtype``."""
    msg, seed = svc.head_round
    return R.ref_head(svc, seed, [R.wire_mix(svc, msg, svc.model["d_model"])],
                      [np.asarray(msg.header.counts, np.int64)], dtype)


def label_gap(feats: torch.Tensor, head: Dict[str, torch.Tensor],
              labels: List) -> float:
    """max over requests of (best logit - the label's logit) / (best -
    worst) under ``feats`` and ``head``; a request with no label reads 1."""
    logits = feats @ head["w"] + head["b"]
    lab = torch.tensor([-1 if v is None else v for v in labels],
                       device=logits.device)
    top, low = logits.amax(-1), logits.amin(-1)
    gap = (top - logits.gather(-1, lab.clamp_min(0)[:, None])[:, 0]) \
        / (top - low).clamp_min(1e-30)
    return float(torch.where(lab < 0, torch.ones_like(gap), gap).max())


def check(svc: Service, out: Dict) -> Dict[str, float]:
    reqs, chk = out["reqs"], svc.mix["check"]
    ext = sample(svc, EXTRACT, chk["feature_rows"])
    got = torch.from_numpy(np.stack([reqs[i].feats for i in ext])).to(svc.dev)
    ref = ref_features(svc, ext)
    head = served_head(svc)
    inf = sample(svc, INFER, chk["infer_rows"])
    nums = {"feat_gap": float(((got - ref).abs().amax(-1)
                               / ref.abs().amax(-1).clamp_min(1e-30)).max()),
            "head_gap": R.param_gap(svc.svc.head, head),
            "label_gap": label_gap(ref_features(svc, inf), head,
                                   [reqs[i].label for i in inf])}
    nums.update(client_numbers(svc, out))
    return nums


def client_numbers(svc: Service, out: Dict, low=None) -> Dict[str, float]:
    """ll_gap, em_gain and the exact counts of the messages sent in the
    window; ``low`` (a client's (feats, labels, seed, i) -> (mixture, lls))
    puts the control's EM in the program's place."""
    reqs, mix = out["reqs"], svc.mix
    C, K = mix["n_classes"], mix["fedpft"]["K"]
    ll = gain = 0.0
    wire_off = count_off = 0
    for c, idx, msg in svc.messages:
        f = torch.from_numpy(np.stack([reqs[j].feats for j in idx])).to(
            svc.dev)
        y = torch.from_numpy(svc.labels[idx]).to(svc.dev)
        d = f.shape[1]
        if low is None:
            sent = np.asarray(msg.header.counts, np.int64)
            count_off += int(np.abs(sent - np.bincount(
                svc.labels[idx], minlength=C)).sum())
            wire_off += abs(len(msg.payload) - RW.payload_bytes(sent, K, d))
            mix_got = {k: torch.from_numpy(v).to(svc.dev) for k, v in
                       RW.decode(msg.payload, sent, K, d).items()}
            ll_got = torch.tensor(msg.logliks, device=svc.dev)
        else:
            mix_got, ll_got = low(f, y, out["wseed"], c)
        ll = R.worst(ll, R.ll_gap(svc, f, y, mix_got, ll_got))
        gain = R.worst(gain, R.em_gain(svc, f, y, mix_got))
    # no client finished in the window: nothing to compare, which fails
    nums = {"ll_gap": ll if svc.messages else None,
            "em_gain": gain if svc.messages else None}
    if low is None:
        nums.update(wire_bytes_off=float(wire_off),
                    count_off=float(count_off))
    return nums


def compare(rec: Dict) -> Dict[str, float]:
    svc, out = rec.pop("state")
    return check(svc, out)
