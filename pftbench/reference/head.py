"""Plain server head of a FedPFT round: Adam on minibatches drawn from the
clients' mixtures.

The server lays the clients' decoded mixtures out as a slot grid, client by
client and class by class (slot s has the label s mod C and draws in
proportion to its class's sample count), and trains a linear head w (d, C),
b (C) from w = 0.01 N(0, 1)/sqrt(d), b = 0 with Adam (b1 0.9, b2 0.999, eps
1e-8, no weight decay) on the mean cross-entropy of ``n_steps`` minibatches of
``batch`` draws.  A draw picks its slot by a uniform against the cumulative
count mass, its component by an exponential race over the slot's pi, and its
value as mu + sqrt(cov) * eps.

The draws are those of the round's server stream (``gmm.round_generator(seed,
0)``), in the order the round makes them: every slot uniform, every
component race, the head's initial normal, then the Gaussian noise
``noise_window`` steps at a time.  ``dtype`` is the precision the steps run
in: float32 as configured, or bfloat16 for the control.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _f32_one_minus_pow(base: float, c: int) -> float:
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(base, dtype=torch.float32) ** c)


@torch.no_grad()
def train(pi: torch.Tensor, mu: torch.Tensor, cov: torch.Tensor,
          counts: torch.Tensor, n_classes: int, cfg: Dict,
          generator: torch.Generator, dtype: torch.dtype = torch.float32
          ) -> Dict[str, torch.Tensor]:
    """The head {w, b} (float32) trained from the slot grid: pi (G, K), mu
    and cov (G, K, d) float32, counts (G,) integer."""
    G, K, d = mu.shape
    dev = mu.device
    n_steps, bs = cfg["n_steps"], cfg["batch"]
    lr, b1, b2, eps_adam = cfg["lr"], 0.9, 0.999, 1e-8
    window = max(1, min(cfg["noise_window"], n_steps))

    mass = counts.float()
    cum = torch.cumsum(mass, 0) / mass.sum().clamp_min(1e-9)
    u = torch.rand((n_steps * bs,), generator=generator, device=dev)
    slot = torch.searchsorted(cum, u, right=True).clamp(0, G - 1)
    race = torch.empty((n_steps * bs, K), device=dev).exponential_(
        1.0, generator=generator)
    comp = (pi.float().clamp_min(1e-20)[slot] / race).argmax(-1)
    normal = torch.randn((d, n_classes), generator=generator, device=dev,
                         dtype=torch.float32)
    w = (normal / math.sqrt(d) * 0.01).to(dtype)
    b = torch.zeros((n_classes,), device=dev, dtype=dtype)
    m = [torch.zeros_like(w), torch.zeros_like(b)]
    v = [torch.zeros_like(w), torch.zeros_like(b)]
    std = cov.clamp_min(0.0).sqrt().reshape(G * K, d)
    labels = torch.arange(G, device=dev) % n_classes
    step = 0
    while step < n_steps:
        width = min(window, n_steps - step)
        noise = torch.randn((width, bs, d), generator=generator, device=dev,
                            dtype=torch.float32)
        sl = slot[step * bs:(step + width) * bs].reshape(width, bs)
        cm = comp[step * bs:(step + width) * bs].reshape(width, bs)
        xs = (mu[sl, cm].float() + std[sl * K + cm] * noise).to(dtype)
        ys = labels[sl]
        for i in range(width):
            x, y = xs[i], ys[i]
            # the gradient of the mean cross-entropy at the logits
            p = torch.softmax((x @ w + b).float(), dim=-1)
            gz = ((p - torch.nn.functional.one_hot(y, n_classes).float())
                  / bs).to(dtype)
            grads = [x.transpose(0, 1) @ gz, gz.sum(0)]
            c = step + 1
            bc1 = _f32_one_minus_pow(b1, c)
            bc2 = _f32_one_minus_pow(b2, c)
            params = [w, b]
            for j, g in enumerate(grads):
                m[j] = b1 * m[j] + (1 - b1) * g
                v[j] = b2 * v[j] + (1 - b2) * g.square()
                params[j] = params[j] - lr * (m[j] / bc1) / (
                    (v[j] / bc2).sqrt() + eps_adam)
            w, b = params
            step += 1
    return {"w": w.float(), "b": b.float()}
