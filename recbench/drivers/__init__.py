"""Drivers of the traffic kinds, one module each, found by a traffic mix's
``kind``: ``Session(ctx)`` sets a cell up and drives its window, and the
module's functions make the cell's inputs and its reference answers."""
