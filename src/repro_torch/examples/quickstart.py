"""Quickstart: HADES keygen -> encrypt -> compare, both modes.

The port of `examples/quickstart.py`; every answer is checked against
the plaintext.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import compare as C
from repro_torch.core import encrypt as E
from repro_torch.core import noise
from repro_torch.core.keys import keygen
from repro_torch.core.params import make_params
from repro_torch.core.ring import resolve_device
from repro_torch.examples import check


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- gadget mode (correct + secure) ----------------------------------
    params = make_params("test-bfv", mode="gadget")
    print(f"ring n={params.n}, towers={params.qs}, scale={params.scale}, "
          f"max comparable |diff|={params.max_operand}")
    budget = noise.predict(params)
    print(f"noise headroom: {budget.headroom_bits:.1f} bits "
          f"(tau={budget.tau}, 6σ={6*budget.eval_sigma:.0f})")

    ks = keygen(params, 0, device=dev)
    a = np.array([42, 7, 100, -5])
    b = np.array([7, 42, 100, 5])
    ct_a = E.encrypt(ks, a, 1)
    ct_b = E.encrypt(ks, b, 2)
    dec = E.decrypt(ks, ct_a).cpu().numpy()
    got = C.compare(ks, ct_a, ct_b).cpu().numpy()
    print("decrypt roundtrip:", dec)
    print("compare(a, b)    :", got, " (expected [1, -1, 0, -1])")
    out = {"roundtrip": check(np.array_equal(dec, a), "decrypt"),
           "compare": check(np.array_equal(got, np.sign(a - b)), "compare")}

    # --- FA-Extension: equality is obfuscated ----------------------------
    eq = np.full((8,), 99)
    ct1 = E.encrypt_fae(ks, eq, 3)
    ct2 = E.encrypt_fae(ks, eq, 4)
    flips = C.compare_fae(ks, ct1, ct2).cpu().numpy()
    print("FAE compare of equal values (coin flips):", flips)
    out["fae_flips"] = flips.astype(int).tolist()

    # --- paper-literal mode ----------------------------------------------
    p2 = make_params("test-bfv", mode="paper")
    ks2 = keygen(p2, 0, device=dev, paper_ecek_weight=0)
    got2 = C.compare(ks2, E.encrypt(ks2, a, 1),
                     E.encrypt(ks2, b, 2)).cpu().numpy()
    print("paper-mode compare:", got2)
    out["paper_compare"] = check(np.array_equal(got2, np.sign(a - b)),
                                 "paper-mode compare")
    return out


if __name__ == "__main__":
    main()
