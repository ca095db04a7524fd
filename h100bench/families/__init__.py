"""Adapters from a configuration file to the program's own config object,
one module per family, named by the configuration's ``family`` key."""
