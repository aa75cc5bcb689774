"""Entry ``multiscale``: ``icp_tpu_torch.converge_multiscale``, the coarse
levels (the configuration's ``factors``, each capped at
``coarse_max_iterations``) seeding the full-resolution loop.

``LOOPS`` names the program's driver-loop functions this entry runs, as
``module:attribute``; a traced call records each loop through them.
"""

LOOPS = ("icp_tpu_torch.driver:converge", "icp_tpu_torch.multiscale:converge")


def call(icp, method, driver, settings, source, target, guess):
    out, _ = icp.converge_multiscale(method, source, target, guess, driver,
                                     factors=tuple(settings["factors"]),
                                     coarse_max_iterations=settings["coarse_max_iterations"])
    return out
