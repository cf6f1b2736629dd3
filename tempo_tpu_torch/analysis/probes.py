"""Linear / MLP probes from VAE latents to L2 atmospheric products;
counterpart of tempo_tpu/analysis/probes.py.

A probe is Linear(in -> 1) or an MLP (in -> hidden... -> 1) with ReLU, GELU
or Tanh and dropout between the layers, as an nn.Module of nn.Linear layers
(PyTorch's default init, drawn from a seeded generator), trained with
torch.optim.AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight_decay) on the
MSE, in shuffled minibatches, keeping the parameters of the epoch with the
best validation loss. The JAX package's conventions hold: the train set is
padded to whole batches with the padded rows at weight 0, each epoch takes
one permutation from the probe's generator, and the validation loss is
computed on the device.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tempo_tpu_torch.device import resolve_device

_ACTS = {"relu": torch.relu,
         "gelu": lambda x: nn.functional.gelu(x, approximate="none"),
         "tanh": torch.tanh}


class Probe(nn.Module):
    """``layers``: the nn.Linear layers of dims [in, *hidden, out]."""

    def __init__(self, dims: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=dev) for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for layer in self.layers:  # PyTorch's default: U(+-1/sqrt(in))
                bound = 1.0 / np.sqrt(layer.in_features)
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, act: str = "relu",
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return probe_apply(self, x, act, dropout, generator)


def init_probe_params(input_dim: int, hidden_dims: Tuple[int, ...],
                      output_dim: int = 1, seed: int = 0,
                      device=None) -> Probe:
    """A probe of dims [input_dim, *hidden_dims, output_dim] on ``device``
    (None: CUDA), initialized from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return Probe([input_dim, *hidden_dims, output_dim], dev, generator)


def probe_apply(probe: Probe, x: torch.Tensor, act: str = "relu",
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each layer, then the activation and (with a generator and dropout >
    0) inverted dropout between layers."""
    act_fn = _ACTS[act]
    h = x
    n = len(probe.layers)
    for i, layer in enumerate(probe.layers):
        h = layer(h)
        if i < n - 1:
            h = act_fn(h)
            if dropout > 0.0 and generator is not None:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 1.0 - dropout
                h = torch.where(keep, h / (1.0 - dropout),
                                torch.zeros_like(h))
    return h


def probe_params(probe: Probe) -> List[Dict[str, np.ndarray]]:
    """The JAX layout of a probe's parameters: [{kernel [in, out], bias}]."""
    return [{"kernel": layer.weight.detach().T.cpu().numpy().copy(),
             "bias": layer.bias.detach().cpu().numpy().copy()}
            for layer in probe.layers]


@dataclass
class ProbeResult:
    params: List[Dict[str, np.ndarray]]  # the JAX layout, probe_params's
    train_losses: List[float]
    val_losses: List[float]
    best_epoch: int
    best_val_loss: float
    architecture: str
    hidden_dims: Tuple[int, ...] = ()
    activation: str = "relu"
    extras: Dict[str, Any] = field(default_factory=dict)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """[N, in] -> [N] on the host, in float32."""
        h = np.asarray(x, dtype=np.float32)
        for i, layer in enumerate(self.params):
            h = h @ layer["kernel"] + layer["bias"]
            if i < len(self.params) - 1:
                h = _ACTS[self.activation](torch.from_numpy(h)).numpy()
        return h.squeeze(-1)

    def save(self, path) -> None:
        flat = {}
        for i, layer in enumerate(self.params):
            flat[f"kernel_{i}"] = np.asarray(layer["kernel"])
            flat[f"bias_{i}"] = np.asarray(layer["bias"])
        np.savez(path, n_layers=len(self.params),
                 architecture=self.architecture, activation=self.activation,
                 **flat)


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / (ss_tot + 1e-30))


def weighted_mse(pred: torch.Tensor, y: torch.Tensor, w: torch.Tensor
                 ) -> torch.Tensor:
    """sum(w (pred - y)^2) / max(sum(w), 1): torch's MSELoss over the rows
    of weight 1."""
    return torch.sum(w * (pred - y) ** 2) / torch.clamp(torch.sum(w), min=1.0)


def train_probe(X_train: np.ndarray, y_train: np.ndarray,
                X_val: np.ndarray, y_val: np.ndarray,
                config: Dict[str, Any], seed: int = 0,
                verbose: bool = False, device=None) -> ProbeResult:
    """config keys (the reference's schema): architecture ('linear' |
    'mlp'), hidden_dims, dropout, activation, learning_rate, weight_decay,
    batch_size, max_epochs. Trains on ``device`` (None: CUDA)."""
    architecture = config.get("architecture", "linear")
    hidden_dims = tuple(config.get("hidden_dims", [512, 512])) \
        if architecture == "mlp" else ()
    dropout = float(config.get("dropout", 0.1)) if architecture == "mlp" \
        else 0.0
    activation = config.get("activation", "relu")
    lr = float(config.get("learning_rate", 1e-3))
    weight_decay = float(config.get("weight_decay", 0.01))
    batch_size = int(config.get("batch_size", 512))
    max_epochs = int(config.get("max_epochs", 100))

    dev = resolve_device(device)
    input_dim = X_train.shape[1]
    # one generator: the init, then each epoch's permutation and dropout
    generator = torch.Generator(device=dev).manual_seed(seed)
    probe = Probe([input_dim, *hidden_dims, 1], dev, generator)
    opt = torch.optim.AdamW(probe.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)

    n_train = X_train.shape[0]
    n_batches = max(1, (n_train + batch_size - 1) // batch_size)
    # the train set padded to whole batches; padded rows get weight 0
    pad = n_batches * batch_size - n_train
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    Xt = put(np.concatenate([X_train, np.zeros((pad, input_dim))]))
    yt = put(np.concatenate([y_train, np.zeros(pad)]))
    wt = put(np.concatenate([np.ones(n_train), np.zeros(pad)]))
    Xv, yv = put(X_val), put(y_val)

    train_losses, val_losses = [], []
    best_val, best_epoch = float("inf"), 0
    best_state = copy.deepcopy(probe.state_dict())
    for epoch in range(max_epochs):
        perm = torch.randperm(n_batches * batch_size, generator=generator,
                              device=dev).view(n_batches, batch_size)
        weighted = torch.zeros((), device=dev)
        for idx in perm:
            wb = wt[idx]
            loss = weighted_mse(probe(Xt[idx], activation, dropout,
                                      generator).squeeze(-1), yt[idx], wb)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            weighted += loss.detach() * wb.sum()
        with torch.no_grad():
            val = torch.mean((probe(Xv, activation).squeeze(-1) - yv) ** 2)
        tl, vl = float(weighted / n_train), float(val)
        train_losses.append(tl)
        val_losses.append(vl)
        if vl < best_val:
            best_val, best_epoch = vl, epoch
            best_state = copy.deepcopy(probe.state_dict())
        if verbose and epoch % 100 == 0:
            print(f"Epoch {epoch}: Train Loss = {tl:.4f}, Val Loss = {vl:.4f}")
    probe.load_state_dict(best_state)
    return ProbeResult(
        params=probe_params(probe), train_losses=train_losses,
        val_losses=val_losses, best_epoch=best_epoch, best_val_loss=best_val,
        architecture=architecture, hidden_dims=hidden_dims,
        activation=activation)
