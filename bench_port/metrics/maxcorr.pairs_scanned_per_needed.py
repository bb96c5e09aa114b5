"""maxcorr.pairs_scanned_per_needed: tile pairs the last scan ran over
those a host read after every pair would run (`MaxCorrScan.stats`:
tile_pairs / tile_pairs_needed): the work queued past the coverage
break by reading the alive seeds once a group."""


def read(ctx):
    st = getattr(ctx.traffic, "stats", {})
    if not st.get("tile_pairs_needed"):
        return None
    return st["tile_pairs"] / st["tile_pairs_needed"]
