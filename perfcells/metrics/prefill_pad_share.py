"""Share of what the window's batched prefills computed that was padding
(rows no request took, and each row's positions past its prompt): the
window's change of the engine's ``prefill_tokens_real`` (the unshared
prompt tokens taken) over its ``prefill_tokens_computed`` (rows x
bucket). A program without these counters reports nothing."""


def read(t):
    computed = t["stats"].get("prefill_tokens_computed")
    if not computed:
        return None
    return 100.0 * (1.0 - t["stats"]["prefill_tokens_real"] / computed)
