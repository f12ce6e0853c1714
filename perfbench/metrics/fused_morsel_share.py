"""fused_morsel_share (%): the fused chain's launches over the window's
COOKs, per morsel the COOKs' shapes give (every morsel of a fused COOK
should take one ``fused_chain_tiles`` launch).  Counted by the port's
launch counter, which counts card launches only."""


def read(run):
    f = run.facts
    if "fused_launches" not in f or not f["cooks"] or not f["fused_launches"]:
        return None
    return 100.0 * f["fused_launches"] / (f["cooks"] * f["morsels_per_cook"])
