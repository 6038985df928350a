"""Launch drivers of the port: the LM serving driver (`serve`) and the
elastic fleet monitor (`elastic`)."""
