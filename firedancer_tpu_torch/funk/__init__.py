from .funk import ROOT_XID, Funk  # noqa: F401
