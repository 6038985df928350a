"""keymul_roofline: the same share for the key multiply
(`negacyclic_mul_ntt`: encryption of inserts and of pad rows) (%)."""
from hbench.readers import roofline_share


def read(win):
    return roofline_share(win, "keymul")
