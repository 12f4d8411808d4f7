"""FedPFT core: parametric feature transfer.

Modules:
  gmm            batched EM over full/diag/spher Gaussian mixtures
  head           linear classifier-head training (the global model's h)
  fedpft         one-shot FedPFT (Algorithm 1) through fl.api.FedSession
  decentralized  chain-topology FedPFT (§4.2) via FedSession(Chain())
  dp             DP-FedPFT Gaussian mechanism (Theorem 4.1)
  theory         Theorem 6.1 bound + Eqs. 9-11 cost model
  reconstruction feature-inversion attack (§6.4)
"""
from repro_torch.core import gmm, head, fedpft, decentralized, dp, theory
from repro_torch.core import reconstruction

__all__ = ["gmm", "head", "fedpft", "decentralized", "dp", "theory",
           "reconstruction"]
