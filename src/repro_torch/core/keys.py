"""Algorithm 1: Key Generation.

Outputs (pk, sk, cek).  Two CEK realizations, as in `repro.core.keys`:

* mode="paper"  : cek = sk*scale + e_cek — the literal Alg. 1 lines 5-8
  (`paper_ecek_weight` keeps only the first w noise coefficients).
* mode="gadget" : RNS-gadget CEK, cek[k,j] = B^j * alpha_k * sk * scale + e
  (key-switching form); Eval digit-decomposes ctΔ,1 first (gadget.py).

`keygen` samples from a seeded `torch.Generator` on the target device,
or takes every sample pre-drawn (sk, a, e_pk, e_cek / e_gadget) so a
test can hand in the reference's samples and require identical keys.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import ring as R
from repro_torch.core import sampling
from repro_torch.core.params import HadesParams


@dataclasses.dataclass
class KeySet:
    params: HadesParams
    ring: R.Ring
    sk: torch.Tensor                   # [K, n] (ternary, RNS-lifted)
    pk0: torch.Tensor                  # [K, n]  -(a*sk + e_pk)
    pk1: torch.Tensor                  # [K, n]  a
    cek: Optional[torch.Tensor]        # paper mode: [K, n]
    cek_gadget: Optional[torch.Tensor]  # gadget mode: [K_src, D, K, n]
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def mode(self) -> str:
        return self.params.mode

    @property
    def device(self) -> torch.device:
        return self.sk.device

    @property
    def cek_gadget_ntt(self) -> torch.Tensor:
        """The gadget CEK in the eval domain (the reference precomputes
        it in keygen).  Computed on request by the plain NTT; the port's
        Eval does not need it, and its NTT kernel (`ntt_br`) is not
        ported yet, so a CUDA KeySet raises."""
        if "cek_gadget_ntt" not in self._cache:
            if self.cek_gadget is None:
                raise ValueError("cek_gadget_ntt needs a gadget-mode KeySet")
            if self.sk.is_cuda:
                raise NotImplementedError(
                    "cek_gadget_ntt on a CUDA tensor needs the ntt_br kernel "
                    "(kernels/ntt.py::ntt_br in the reference), not ported yet")
            K, n = self.params.num_towers, self.params.n
            flat = self.cek_gadget.reshape(-1, K, n)
            self._cache["cek_gadget_ntt"] = R.ntt(self.ring, flat).reshape(
                self.cek_gadget.shape)
        return self._cache["cek_gadget_ntt"]

    @property
    def cek_rev(self) -> torch.Tensor:
        """The gadget CEK reversed and sign-flipped along n, [K_src, D, K, n]:
        rev[..., 0] = c[..., 0], rev[..., i] = -c[..., n-i] mod q.  Then
        coeff0 of x ⊛ c is the dot product <x, rev(c)>, which is how the
        Eval kernel computes the gadget key-multiply without NTTs."""
        if "cek_rev" not in self._cache:
            if self.cek_gadget is None:
                raise ValueError("cek_rev needs a gadget-mode KeySet")
            c = self.cek_gadget
            tail = (-torch.flip(c[..., 1:], dims=[-1])) % self.ring.q_arr
            self._cache["cek_rev"] = torch.cat([c[..., :1], tail],
                                               dim=-1).contiguous()
        return self._cache["cek_rev"]

    @classmethod
    def from_numpy(cls, params: HadesParams, *, sk, pk0, pk1, cek=None,
                   cek_gadget=None, device=None) -> "KeySet":
        """A KeySet over given key material (e.g. a reference KeySet's
        arrays through `np.asarray`)."""
        dev = R.resolve_device(device)
        as_t = lambda a: None if a is None else R.int64_tensor(a, dev)  # noqa: E731
        return cls(params=params, ring=R.make_ring(params, dev),
                   sk=as_t(sk), pk0=as_t(pk0), pk1=as_t(pk1),
                   cek=as_t(cek), cek_gadget=as_t(cek_gadget))


def _gadget_cek(params: HadesParams, rng: R.Ring, sk: torch.Tensor,
                e_gadget: torch.Tensor) -> torch.Tensor:
    """cek[k_src, j] = alpha_{k_src} * B^j * scale * sk + e  (mod Q), RNS.

    e_gadget: [K*D, K, n] noise polys, entry k_src*D + j."""
    K, n = params.num_towers, params.n
    D = params.gadget_digits_per_tower
    entries = []
    for k_src in range(K):
        for j in range(D):
            # host-side big-int constant:  alpha_k * B^j * scale  mod Q
            c = (params.crt_alphas()[k_src] * pow(params.gadget_base, j)
                 % params.Q) * params.scale % params.Q
            c_rns = torch.tensor([c % q for q in params.qs],
                                 dtype=torch.int64, device=sk.device)[:, None]
            entries.append(((sk * c_rns) % rng.q_arr
                            + e_gadget[k_src * D + j]) % rng.q_arr)
    return torch.stack(entries).reshape(K, D, K, n)


def keygen(params: HadesParams, seed: int | torch.Generator = 0, *,
           device=None, paper_ecek_weight: Optional[int] = None,
           sk=None, a=None, e_pk=None, e_cek=None, e_gadget=None) -> KeySet:
    """Algorithm 1 on `device` (CUDA unless asked otherwise).

    `seed` is an int or a `torch.Generator` on that device.  Any of the
    samples may be passed pre-drawn instead ([K, n] residues; e_gadget
    [K*D, K, n]).  paper_ecek_weight: #nonzero coeffs of e_cek (paper
    mode); None => full-density U(-B_e,B_e) noise exactly as written."""
    dev = R.resolve_device(device)
    gen = sampling.make_generator(seed, dev)
    rng = R.make_ring(params, dev)
    as_t = lambda x: R.int64_tensor(x, dev)  # noqa: E731
    K, D = params.num_towers, params.gadget_digits_per_tower

    sk = as_t(sk) if sk is not None else sampling.ternary_poly(params, gen)
    a = as_t(a) if a is not None else sampling.uniform_poly(params, gen)
    e_pk = as_t(e_pk) if e_pk is not None else sampling.noise_poly(params, gen)
    pk0 = R.neg(rng, R.add(rng, R.negacyclic_mul(rng, a, sk), e_pk))

    # line 5: scale > max(2*B_e, ||sk||_inf)
    if not params.scale > max(2 * params.noise_bound, 1):
        raise ValueError("profile violates Alg.1 line 5 scale condition")

    cek = cek_gadget = None
    if params.mode == "paper":
        e_cek = (as_t(e_cek) if e_cek is not None
                 else sampling.noise_poly(params, gen))
        if paper_ecek_weight is not None:
            mask = torch.arange(params.n, device=dev) < paper_ecek_weight
            e_cek = e_cek * mask
        cek = R.add(rng, R.scalar_mul(rng, sk, params.scale), e_cek)
    else:
        e_gadget = (as_t(e_gadget) if e_gadget is not None
                    else sampling.noise_poly(params, gen, (K * D,)))
        cek_gadget = _gadget_cek(params, rng, sk, e_gadget)
    return KeySet(params=params, ring=rng, sk=sk, pk0=pk0, pk1=a,
                  cek=cek, cek_gadget=cek_gadget)
