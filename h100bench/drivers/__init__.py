"""One driver per kind of mix (today ``serve``), named by the mix's ``kind``."""
