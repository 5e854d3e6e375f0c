"""Program-side builders: each ``<circuit>.py`` records a configuration's
circuit on a ``rustqip_tpu_torch`` builder through the port's public
algorithms, from the parameters the traffic drew."""
