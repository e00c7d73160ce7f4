"""Scene generators: `<scene>.py` builds one world of the scene that a
configuration names, through the `WorldBuilder` of the package it is
given, from the configuration and one row of offsets drawn from the seed."""
