"""Launch drivers of the port: the LM serving driver (`serve`), the
training driver (`train`) and the elastic fleet monitor (`elastic`)."""
