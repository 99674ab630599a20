"""Product quantisation codec (port of ``grafp_tpu.retrieval.pq``; the
FAISS IVFPQ role: 64 subspaces x 8-bit codes for d = 128 fingerprints,
reference eval.py:65-69).

Search scores PQ reconstructions with a dense distance product (decoded
blockwise, or from a decoded bf16 cache, ``index.IndexIVFPQ``): the same
||q - reconstruction||^2 as asymmetric ADC, with the lookups traded for a
product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grafp_tpu_torch.retrieval.kmeans import ASSIGN_ROWS, assign, kmeans


class ProductQuantizer:
    """d-dim vectors -> (n_sub) uint8 codes, ksub = 256 (8 bits)."""

    def __init__(self, d: int, n_sub: int = 64, ksub: int = 256):
        if d % n_sub:
            raise ValueError(f"d={d} is not a multiple of n_sub={n_sub}")
        self.d = d
        self.n_sub = n_sub
        self.dsub = d // n_sub
        self.ksub = ksub
        self.codebooks: Optional[torch.Tensor] = None   # (n_sub, ksub, dsub)

    def _subspaces(self, data: torch.Tensor) -> torch.Tensor:
        return data.reshape(data.shape[0], self.n_sub, self.dsub).transpose(0, 1)

    def train(self, data: torch.Tensor, iters: int = 20,
              generator: Optional[torch.Generator] = None,
              init: Optional[torch.Tensor] = None,
              reseed: Optional[torch.Tensor] = None) -> None:
        """One k-means per subspace over data (M, d) f32 on its device;
        draws as ``kmeans.kmeans`` takes them, (n_sub, ksub) and (n_sub,
        iters, ksub)."""
        self.codebooks, _ = kmeans(self._subspaces(data).contiguous(), self.ksub,
                                   iters, generator=generator, init=init,
                                   reseed=reseed)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(M, d) -> (M, n_sub) uint8, in chunks of ``kmeans.ASSIGN_ROWS``
        rows (the whole (n_sub, M, ksub) score tensor would be 64 GiB at
        M = 2^20)."""
        out = [assign(self._subspaces(data[s:s + ASSIGN_ROWS]), self.codebooks).T
               for s in range(0, data.shape[0], ASSIGN_ROWS)]
        if not out:
            return torch.zeros((0, self.n_sub), dtype=torch.uint8, device=data.device)
        return torch.cat(out).to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(M, n_sub) uint8 -> (M, d) reconstructions, on the codes' device."""
        sidx = torch.arange(self.n_sub, device=codes.device)[None, :]
        return self.codebooks[sidx, codes.long()].reshape(codes.shape[0], self.d)

    def decode_host(self, codes, dtype=None) -> np.ndarray:
        """Host (numpy) decode in row chunks of 2^20, cast per chunk to
        ``dtype`` (f32 when None)."""
        codes = np.asarray(codes)
        cb = self.codebooks.detach().cpu().numpy()              # (S, ksub, dsub)
        out = np.empty((codes.shape[0], self.d), dtype or np.float32)
        sidx = np.arange(self.n_sub)[None, :]
        for s0 in range(0, codes.shape[0], 1 << 20):
            c = codes[s0:s0 + (1 << 20)].astype(np.intp)
            dec = cb[sidx, c].reshape(len(c), self.d)
            out[s0:s0 + len(c)] = dec if dtype is None else dec.astype(dtype)
        return out

    def state(self) -> dict:
        return {"codebooks": self.codebooks, "d": self.d, "n_sub": self.n_sub,
                "ksub": self.ksub}

    @staticmethod
    def from_state(st, device: Optional[torch.device] = None) -> "ProductQuantizer":
        """A quantizer from ``state()``, or from the JAX package's state
        (codebooks as any array), with its codebooks as f32 on ``device``
        (the codebooks' own device when None)."""
        pq = ProductQuantizer(int(st["d"]), int(st["n_sub"]), int(st["ksub"]))
        cb = st["codebooks"]
        if not torch.is_tensor(cb):
            cb = torch.tensor(np.asarray(cb, np.float32))
        pq.codebooks = cb.to(device) if device is not None else cb
        return pq
