"""The HADES examples on PyTorch: counterparts of the reference's
`examples/*.py`, each run as `python -m repro_torch.examples.<name>`
(on the card by default; `--device cpu` runs the plain paths)."""


def check(ok: bool, what: str) -> bool:
    """Raise unless `ok`: an example's answer disagrees with the
    plaintext.  Returns True, so a result can record it."""
    if not ok:
        raise RuntimeError(f"wrong answer: {what}")
    return True
