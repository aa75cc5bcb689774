"""The reference's schedule of entry ``converge``: one driver loop under the
driver settings."""


def register(loop, settings, src, src_n, tgt, tgt_n, rot, trans):
    return loop(src, src_n, tgt, tgt_n, rot, trans, settings["driver"])
