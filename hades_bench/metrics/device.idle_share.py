"""device.idle_share: the share of the traced window in which no
operation ran on the card (%)."""


def read(win):
    if win.device is None or not win.device.events:
        return None
    return 100.0 * (1.0 - win.device.busy_s / win.seconds)
