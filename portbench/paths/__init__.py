"""One module per path of the program that a traffic mix can drive, found
by the traffic file's ``path``."""
