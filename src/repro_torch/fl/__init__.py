"""Federation: the session API (summarizer × wire codec × topology × DP)
and the paper's head-level baselines.

``api.FedSession`` composes a summarizer (per-class GMMs, or locally
trained heads for the one-shot baselines), a real ``QuantizedCodec``
wire, a topology (star / chain / ring) and an optional DP hook.
``baselines`` holds the methods the paper compares against (Figures 1/4,
Tables 2/5): multi-round FedAvg, FedProx, FedYogi, DSFL; one-shot AVG,
Ensemble, FedBE (through ``FedSession(summarizer=HeadSummarizer())``)
and KD.
"""
from repro_torch.fl import api, baselines, planner
from repro_torch.fl.api import (Chain, ClientMessage, FedSession,
                                GMMSummarizer, HeadSummarizer,
                                QuantizedCodec, Ring, Star,
                                synthesize_batched, synthesize_chunks)
from repro_torch.fl.baselines import (MultiRoundConfig, avg_heads,
                                      ensemble_predict, fedavg, fedbe,
                                      head_comm_bytes, kd_transfer,
                                      local_train)
from repro_torch.fl.planner import SlotTable, SynthesisPlan, plan_synthesis

__all__ = ["MultiRoundConfig", "fedavg", "local_train", "avg_heads",
           "ensemble_predict", "fedbe", "kd_transfer", "head_comm_bytes",
           "api", "baselines", "planner", "FedSession", "GMMSummarizer",
           "HeadSummarizer", "QuantizedCodec", "Star", "Chain", "Ring",
           "ClientMessage", "synthesize_batched", "synthesize_chunks",
           "SlotTable", "SynthesisPlan", "plan_synthesis"]
