"""One driver per kind of traffic (a traffic file's ``driver``)."""
