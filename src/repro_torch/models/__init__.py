"""The LM framework's models (dense family): layers, parameters, the
decoder-only transformer and the :class:`~repro_torch.models.modeling.Model`
facade."""
