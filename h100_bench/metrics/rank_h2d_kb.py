"""Bytes a ranking request hands to the card (``rank_h2d_kb``): the port's
``serve.H2D_BYTES`` over ``serve.REQUESTS``, both counted on every call of
``Scorer.rank_candidates_batch`` in the run (warm-up, window and traced
requests), in kB.  None where the port has no such counters."""


def read(r):
    from plnlp_tpu_torch import serve

    requests, sent = getattr(serve, "REQUESTS", 0), getattr(serve, "H2D_BYTES", None)
    if not requests or sent is None:
        return None
    return sent / requests / 1000
