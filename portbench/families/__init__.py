"""The network families of the plain reference and the yardstick, one file
each, found by the configuration's ``family`` (``spec.family``)."""
