"""Entry ``converge``: one driver loop, ``icp_tpu_torch.driver.converge``.

``LOOPS`` names the program's driver-loop functions this entry runs, as
``module:attribute``; a traced call records each loop through them.
"""

LOOPS = ("icp_tpu_torch.driver:converge",)


def call(icp, method, driver, settings, source, target, guess):
    out, _ = icp.driver.converge(method, source, target, guess, driver)
    return out
