"""The whole train step: the model FLOPs the configuration's family
counts (``model_flops``; for the Mistral family 6 N tokens with N the
matmul parameters a token meets, plus causal attention; no recompute,
no embedding gather, no empty capacity slot) over the traced run's
measured window, as a share of the cards' bf16 peak, in %."""


def read(r):
    if r.chip is None or r.window_s <= 0:
        return None
    batch = r.tokens_per_step // int(r.traffic["seq"])
    flops = r.family.model_flops(r.shape, batch, int(r.traffic["seq"]))
    rate = flops * r.window_steps / r.window_s
    return 100.0 * rate / (r.chips * r.chip["bf16_flops"])
