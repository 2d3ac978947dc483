"""Multi-tenant serving (counterpart of ``oryx_tpu/tenancy``): only the
request-scoped tenant identity (``context``) is ported, which the
admission ladder and the native HTTP front read. Tenant specs, the
serving mux and the multi-tenant pipelines are not: the serving layer
refuses a config that declares enabled tenants.
"""
