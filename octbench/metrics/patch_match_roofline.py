"""patch_match_roofline: the least time on the card of the slice's
zero-guess patch-match searches (roofline.patch_match_bound_s, counted by
rooflines.json's "patch_match" entry, a lower bound on any form's work)
over their device time (patch_match_ms's), in percent.  None where
patch_match_ms is None."""

from octbench import roofline, spec


def read(run):
    ms = spec.metric_reader("patch_match_ms")(run)
    if ms is None:
        return None
    cfg = run.config
    bound_s = roofline.patch_match_bound_s(cfg["settings"], cfg["rows"], cfg["cols"],
                                           run.slice_pairs)
    return 100.0 * bound_s / (ms / 1e3 * run.slice_pairs)
