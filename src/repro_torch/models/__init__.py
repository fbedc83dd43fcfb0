"""Model assembly of the port: layers, attention block, LM, converter."""
