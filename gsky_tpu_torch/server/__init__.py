"""The OGC front end: WMS GetCapabilities and GetMap over HTTP."""
