"""The plain reference of MLPerf's DLRM-DCNv2 forward pass (TorchRec's
``DLRM_DCN``, ``recommendation_v2/torchrec_dlrm`` of
github.com/mlcommons/training), in plain PyTorch and float32.

It imports nothing of the program.  It takes the program's parameter dict
(``{"tables": {"t0": (rows, d), ...}, "bottom": [{"w", "b"}, ...],
"cross": [{"v", "w", "b"}, ...], "top": [...]}``, each layer ``x @ w +
b``) and the bags as the benchmark's requests hold them (one array of row
ids a sample a table), and computes, a block of samples at a time:

1. each bag as the sum of its distinct rows of the logical table;
2. the bottom MLP, ReLU after every layer;
3. ``x_0 = [bottom output, emb_0, ..., emb_{T-1}]`` and the low-rank cross
   layers ``x_{l+1} = x_0 * ((x_l @ v_l) @ w_l + b_l) + x_l``;
4. the top MLP, ReLU after every layer but the last: one logit a sample.

Departure from TorchRec: its sum pooling would count a repeated id
twice; this sums a bag's distinct rows, as the program's server does (the
benchmark's ``fixed`` bags never repeat an id).  TF32 is off for matrix
products on the card while :func:`forward` runs, so that float32 means
float32; the caller's settings are restored when it returns.
"""

from __future__ import annotations

import numpy as np
import torch

#: samples computed at a time
BLOCK_SAMPLES = 4096


def _mlp(layers, x: torch.Tensor, final_linear: bool) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def pool(table: torch.Tensor, bags) -> torch.Tensor:
    """``(len(bags), d)`` float32 sums of each bag's distinct rows."""
    device = table.device
    bags = [np.unique(np.asarray(b, dtype=np.int64)) for b in bags]
    lens = torch.tensor([b.size for b in bags], dtype=torch.int64, device=device)
    ids = torch.from_numpy(np.concatenate(bags)).to(device)
    owner = torch.repeat_interleave(torch.arange(len(bags), device=device), lens)
    out = torch.zeros((len(bags), table.shape[1]), dtype=torch.float32, device=device)
    return out.index_add_(0, owner, table.index_select(0, ids).float())


def forward(params: dict, dense: torch.Tensor, bags: dict) -> torch.Tensor:
    """Logits ``(b,)`` float32 for ``dense`` ``(b, 13)`` and ``bags[name]``,
    ``b`` bags of row ids for each table ``name`` of ``params["tables"]``.
    TF32 is off inside the call and back as it was after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(params, dense, bags)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _forward(params: dict, dense: torch.Tensor, bags: dict) -> torch.Tensor:
    names = sorted(params["tables"], key=lambda n: int(n[1:]))
    out = []
    with torch.no_grad():
        for start in range(0, dense.shape[0], BLOCK_SAMPLES):
            stop = min(start + BLOCK_SAMPLES, dense.shape[0])
            x = _mlp(params["bottom"], dense[start:stop].float(), final_linear=False)
            x0 = torch.cat([x] + [pool(params["tables"][n], bags[n][start:stop])
                                  for n in names], dim=-1)
            x = x0
            for p in params["cross"]:
                x = x0 * ((x @ p["v"]) @ p["w"] + p["b"]) + x
            out.append(_mlp(params["top"], x, final_linear=True)[:, 0])
    return torch.cat(out)
