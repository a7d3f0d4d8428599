"""Host ms from calling the fit's step hook (``Trainer.train_step``) to
its return, a mean over the measured window's steps: what the host
spends issuing a step, its one read that sizes the slot buffers
included (host clock)."""


def read(ctx):
    h = ctx["host"]
    if ctx["kind"] != "train" or not h.get("items"):
        return None
    return 1e3 * h["dispatch_s"] / h["items"]
