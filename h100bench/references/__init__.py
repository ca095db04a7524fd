"""Plain references, one module per family, named by a configuration's ``reference`` key."""
