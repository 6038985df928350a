"""eval_gadget_roofline: the gadget Eval's bound (`hbench.roofline`),
summed over the wrapper calls of the traced window, over the device
seconds of its kernel in the same window (%)."""
from hbench.readers import roofline_share


def read(win):
    return roofline_share(win, "eval_gadget")
