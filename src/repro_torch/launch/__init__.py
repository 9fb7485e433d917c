"""Entry points of the port: the serving launcher (``serve``) and the
training launcher (``train``)."""
