"""HADES x LM serving: encrypted top-k over model scores.

The port of `examples/secure_topk_serving.py`.  An outsourced LM server
produces candidate scores (last-token logits of a smollm-family model
over a candidate set).  The score owner encrypts them; the DB layer
picks the top-k WITHOUT learning the scores, via HADES comparisons.
Each pick is checked to score within the CKKS equality tolerance of the
plaintext k-th score (a tie within it may reorder).

    PYTHONPATH=src python -m repro_torch.examples.secure_topk_serving \\
        [--device cpu]

`chip_smoke.py`'s lm phase runs the same bridge at full size.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import compare as C
from repro_torch.core import encrypt as E
from repro_torch.core.ckks import equality_tolerance
from repro_torch.core.keys import keygen
from repro_torch.core.params import make_params
from repro_torch.core.ring import resolve_device
from repro_torch.examples import check
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. the LM produces scores --------------------------------------
    cfg = configs.get_reduced("smollm_360m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 16)),
                             dtype=torch.int32, device=dev)
    logits, _ = SV.prefill(cfg, params, {"tokens": tokens})
    n_cand = 16
    cand = rng.choice(cfg.vocab_size, n_cand, replace=False)
    scores = logits[0].double().cpu().numpy()[cand]  # [n_cand] float scores
    print("candidate scores:", np.round(scores, 2))

    # --- 2. client encrypts scores (CKKS profile: floats) ---------------
    hp = make_params("test-ckks", mode="gadget")
    ks = keygen(hp, 3, device=dev)
    tol = equality_tolerance(hp)
    enc_scores = E.encrypt(ks, torch.as_tensor(scores, device=dev), 4)

    # --- 3. server-side encrypted top-k ---------------------------------
    k = 4
    _, top_idx = C.encrypted_topk(ks, enc_scores, k)
    top_idx = top_idx.cpu().numpy()
    picked = cand[top_idx]
    exact = cand[np.argsort(scores)[-k:]]
    print(f"encrypted top-{k} tokens: {sorted(picked.tolist())}")
    print(f"plaintext top-{k} tokens: {sorted(exact.tolist())}")
    print(f"(CKKS equality tolerance: |Δscore| < {tol:.3g} "
          f"counts as a tie and may reorder)")
    kth = np.sort(scores)[-k]
    ok = len(set(top_idx.tolist())) == k and np.all(
        scores[top_idx] >= kth - tol)
    return {"topk_ok": check(bool(ok), "encrypted top-k below the "
                                       "plaintext k-th score"),
            "picked": sorted(picked.tolist()),
            "exact": sorted(exact.tolist())}


if __name__ == "__main__":
    main()
