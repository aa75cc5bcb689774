"""The reference's schedule of entry ``multiscale``: the coarse levels run
on every ``f``-th point (largest ``f`` first) with ``max_iterations`` capped
at ``coarse_max_iterations``, each seeding the next, then the full clouds
run under the driver settings."""


def register(loop, settings, src, src_n, tgt, tgt_n, rot, trans):
    driver = settings["driver"]
    for f in sorted(settings["factors"], reverse=True):
        if f <= 1:
            continue
        coarse = dict(driver, max_iterations=min(driver["max_iterations"],
                                                 settings["coarse_max_iterations"]))
        got = loop(src[:, ::f], (src_n + f - 1) // f, tgt[:, ::f], (tgt_n + f - 1) // f,
                   rot, trans, coarse)
        rot, trans = got["rotation"], got["translation"]
    return loop(src, src_n, tgt, tgt_n, rot, trans, driver)
